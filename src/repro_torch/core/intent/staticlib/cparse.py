"""Recursive-descent parser for the C-like I/O kernel dialect → AST.

The grammar is deliberately permissive: it accepts the subset of C the
corpus kernels use (functions, declarations, ``if``/``for``/``while``/
``do``, expression statements, the full C operator precedence ladder,
casts, ``sizeof``, member access, calls) without a real type system.
Anything it cannot parse raises ``ParseError``, which the extractor
treats as "not C" and routes to the regex fallback.

A copy of ``repro.core.intent.staticlib.cparse``;
the port imports nothing of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.intent.staticlib.lexer import LexError, Token, tokenize


class ParseError(ValueError):
    """Raised when the token stream is not the C-like dialect."""


# ---------------------------------------------------------------------------
# AST nodes
# ---------------------------------------------------------------------------
@dataclass
class Node:
    """Base AST node; ``line`` anchors provenance call sites."""
    line: int = 0


@dataclass
class Num(Node):
    """Numeric literal (kept as text; ``value`` when it parses as int)."""
    text: str = "0"

    @property
    def value(self) -> Optional[int]:
        """Integer value, or None for floats/suffixed literals."""
        try:
            return int(self.text, 0)
        except ValueError:
            return None


@dataclass
class Str(Node):
    """String literal (unescaped text, no quotes)."""
    text: str = ""


@dataclass
class Ident(Node):
    """Identifier reference."""
    name: str = ""


@dataclass
class Call(Node):
    """Function call; ``name`` is the flat callee name ("" if complex)."""
    fn: Node = None
    args: List[Node] = field(default_factory=list)

    @property
    def name(self) -> str:
        """Callee identifier if the callee is a plain name."""
        return self.fn.name if isinstance(self.fn, Ident) else ""


@dataclass
class BinOp(Node):
    """Binary operation (arithmetic, comparison, logical, bit)."""
    op: str = ""
    lhs: Node = None
    rhs: Node = None


@dataclass
class UnOp(Node):
    """Prefix/postfix unary operation (``op`` includes "post++" etc.)."""
    op: str = ""
    operand: Node = None


@dataclass
class Assign(Node):
    """Assignment; ``op`` is "=", "+=", ... ``target`` is an lvalue."""
    op: str = "="
    target: Node = None
    value: Node = None


@dataclass
class Member(Node):
    """Member access ``obj.name`` / ``obj->name``."""
    obj: Node = None
    name: str = ""
    arrow: bool = False


@dataclass
class Index(Node):
    """Array subscript ``base[index]``."""
    base: Node = None
    index: Node = None


@dataclass
class Cast(Node):
    """C cast ``(type) expr``."""
    type_name: str = ""
    expr: Node = None


@dataclass
class SizeOf(Node):
    """``sizeof(...)`` with the raw argument text."""
    arg: str = ""


@dataclass
class Cond(Node):
    """Ternary ``c ? a : b``."""
    cond: Node = None
    then: Node = None
    orelse: Node = None


# ---- statements -----------------------------------------------------------
@dataclass
class Block(Node):
    """Brace-delimited statement list."""
    stmts: List[Node] = field(default_factory=list)


@dataclass
class Decl(Node):
    """Local declaration ``type name[dims] = init;``."""
    type_text: str = ""
    name: str = ""
    init: Optional[Node] = None


@dataclass
class ExprStmt(Node):
    """Expression statement."""
    expr: Node = None


@dataclass
class If(Node):
    """``if (cond) then [else orelse]``."""
    cond: Node = None
    then: Node = None
    orelse: Optional[Node] = None


@dataclass
class For(Node):
    """``for (init; cond; step) body``."""
    init: Optional[Node] = None
    cond: Optional[Node] = None
    step: Optional[Node] = None
    body: Node = None


@dataclass
class While(Node):
    """``while (cond) body`` (``do_while`` for post-tested loops)."""
    cond: Node = None
    body: Node = None
    do_while: bool = False


@dataclass
class Return(Node):
    """``return [expr];``."""
    expr: Optional[Node] = None


@dataclass
class Jump(Node):
    """``break;`` / ``continue;``."""
    kind: str = "break"


@dataclass
class Param(Node):
    """One function parameter: flat type text + name."""
    type_text: str = ""
    name: str = ""


@dataclass
class FuncDef(Node):
    """Function definition."""
    ret_type: str = ""
    name: str = ""
    params: List[Param] = field(default_factory=list)
    body: Block = None


@dataclass
class Program(Node):
    """Parsed translation unit: the function definitions."""
    funcs: List[FuncDef] = field(default_factory=list)


_TYPE_KEYWORDS = {
    "void", "char", "short", "int", "long", "float", "double", "signed",
    "unsigned", "const", "static", "struct", "enum", "union", "size_t",
    "ssize_t", "off_t", "mode_t", "uint8_t", "uint16_t", "uint32_t",
    "uint64_t", "int8_t", "int16_t", "int32_t", "int64_t", "bool",
    "MPI_Offset", "MPI_File", "MPI_Comm", "MPI_Status", "MPI_Info",
    "MPI_Datatype", "FILE",
}
_STMT_KEYWORDS = {"if", "else", "for", "while", "do", "return", "break",
                  "continue", "sizeof", "switch", "case", "default", "goto"}


class _Parser:
    def __init__(self, toks: List[Token]):
        self.toks = toks
        self.i = 0

    # -- token plumbing -----------------------------------------------------
    def peek(self, off: int = 0) -> Token:
        j = min(self.i + off, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def accept(self, text: str) -> Optional[Token]:
        t = self.peek()
        if t.kind == "punct" and t.text == text:
            return self.next()
        return None

    def expect(self, text: str) -> Token:
        t = self.next()
        if t.kind != "punct" or t.text != text:
            raise ParseError(f"line {t.line}: expected {text!r}, "
                             f"got {t.text!r}")
        return t

    # -- program / functions -------------------------------------------------
    def parse_program(self) -> Program:
        prog = Program(line=1)
        while self.peek().kind != "eof":
            fn = self._try_function()
            if fn is not None:
                prog.funcs.append(fn)
            else:
                self._skip_top_level()
        return prog

    def _looks_like_type(self, off: int = 0) -> bool:
        t = self.peek(off)
        if t.kind != "ident":
            return False
        if t.text in _TYPE_KEYWORDS:
            return True
        # "ident ident" or "ident * ident": user-defined type
        j = off + 1
        while self.peek(j).kind == "punct" and self.peek(j).text == "*":
            j += 1
        return self.peek(j).kind == "ident" and \
            self.peek(j).text not in _STMT_KEYWORDS

    def _parse_type(self) -> str:
        parts = []
        while True:
            t = self.peek()
            if t.kind == "ident" and (t.text in _TYPE_KEYWORDS or
                                      not parts or
                                      parts[-1] in ("struct", "enum",
                                                    "union", "const")):
                parts.append(self.next().text)
            elif t.kind == "punct" and t.text == "*":
                parts.append(self.next().text)
            else:
                break
        if not parts:
            raise ParseError(f"line {self.peek().line}: expected a type")
        return " ".join(parts)

    def _try_function(self) -> Optional[FuncDef]:
        start = self.i
        try:
            if not self._looks_like_type():
                return None
            ret = self._parse_type()
            name_t = self.next()
            if name_t.kind != "ident":
                raise ParseError(f"line {name_t.line}: expected name")
            self.expect("(")
            params = self._parse_params()
            if not self.accept("{"):
                raise ParseError(
                    f"line {self.peek().line}: not a function body")
            body = self._parse_block(name_t.line)
            return FuncDef(line=name_t.line, ret_type=ret, name=name_t.text,
                          params=params, body=body)
        except ParseError:
            self.i = start
            return None

    def _parse_params(self) -> List[Param]:
        params: List[Param] = []
        if self.accept(")"):
            return params
        while True:
            t = self.peek()
            if t.kind == "ident" and t.text == "void" and \
                    self.peek(1).text == ")":
                self.next()
                break
            ty = self._parse_type()
            # the last component of the "type" may actually be the name
            name = ""
            nt = self.peek()
            if nt.kind == "ident":
                name = self.next().text
            else:
                bits = ty.rsplit(" ", 1)
                if len(bits) == 2 and not bits[1] == "*":
                    ty, name = bits
            while self.accept("["):
                while not self.accept("]"):
                    self.next()
            params.append(Param(line=t.line, type_text=ty, name=name))
            if not self.accept(","):
                break
        self.expect(")")
        return params

    def _skip_top_level(self) -> None:
        """Skip one unparseable top-level construct (decl, typedef, ...)."""
        depth = 0
        while True:
            t = self.next()
            if t.kind == "eof":
                return
            if t.kind == "punct":
                if t.text == "{":
                    depth += 1
                elif t.text == "}":
                    depth -= 1
                    if depth <= 0 and self.peek().text in (";", ""):
                        self.accept(";")
                        return
                elif t.text == ";" and depth == 0:
                    return

    # -- statements ----------------------------------------------------------
    def _parse_block(self, line: int) -> Block:
        blk = Block(line=line)
        while not self.accept("}"):
            if self.peek().kind == "eof":
                raise ParseError(f"line {line}: unterminated block")
            blk.stmts.append(self._parse_stmt())
        return blk

    def _parse_stmt(self) -> Node:
        t = self.peek()
        if t.kind == "punct" and t.text == "{":
            self.next()
            return self._parse_block(t.line)
        if t.kind == "punct" and t.text == ";":
            self.next()
            return Block(line=t.line)
        if t.kind == "ident":
            if t.text == "if":
                return self._parse_if()
            if t.text == "for":
                return self._parse_for()
            if t.text == "while":
                self.next()
                self.expect("(")
                cond = self._parse_expr()
                self.expect(")")
                return While(line=t.line, cond=cond, body=self._parse_stmt())
            if t.text == "do":
                self.next()
                body = self._parse_stmt()
                kw = self.next()
                if kw.text != "while":
                    raise ParseError(f"line {kw.line}: expected while")
                self.expect("(")
                cond = self._parse_expr()
                self.expect(")")
                self.expect(";")
                return While(line=t.line, cond=cond, body=body,
                             do_while=True)
            if t.text == "return":
                self.next()
                expr = None
                if not (self.peek().kind == "punct" and
                        self.peek().text == ";"):
                    expr = self._parse_expr()
                self.expect(";")
                return Return(line=t.line, expr=expr)
            if t.text in ("break", "continue"):
                self.next()
                self.expect(";")
                return Jump(line=t.line, kind=t.text)
            if self._looks_like_type() and self.peek(1).kind != "punct":
                return self._parse_decl()
            if self._looks_like_type():
                # e.g. "char *p = ..." — type then '*' then name
                j = 1
                while self.peek(j).text == "*":
                    j += 1
                if self.peek(j).kind == "ident":
                    return self._parse_decl()
        expr = self._parse_expr()
        self.expect(";")
        return ExprStmt(line=t.line, expr=expr)

    def _parse_decl(self) -> Node:
        t = self.peek()
        ty = self._parse_type()
        # _parse_type may have swallowed the name as part of the type
        if self.peek().kind == "ident":
            name = self.next().text
        else:
            bits = ty.rsplit(" ", 1)
            if len(bits) != 2:
                raise ParseError(f"line {t.line}: bad declaration")
            ty, name = bits
        while self.accept("["):
            while not self.accept("]"):
                if self.peek().kind == "eof":
                    raise ParseError(f"line {t.line}: bad array dim")
                self.next()
        init = None
        if self.accept("="):
            init = self._parse_assign()
        # multi-declarator lists: keep only the first, skip the rest
        while self.accept(","):
            while self.peek().text not in (",", ";") and \
                    self.peek().kind != "eof":
                self.next()
        self.expect(";")
        return Decl(line=t.line, type_text=ty, name=name, init=init)

    def _parse_if(self) -> If:
        t = self.next()
        self.expect("(")
        cond = self._parse_expr()
        self.expect(")")
        then = self._parse_stmt()
        orelse = None
        if self.peek().kind == "ident" and self.peek().text == "else":
            self.next()
            orelse = self._parse_stmt()
        return If(line=t.line, cond=cond, then=then, orelse=orelse)

    def _parse_for(self) -> For:
        t = self.next()
        self.expect("(")
        init = None
        if not self.accept(";"):
            if self._looks_like_type():
                init = self._parse_decl()          # consumes ';'
            else:
                init = ExprStmt(line=t.line, expr=self._parse_expr())
                self.expect(";")
        cond = None
        if not self.accept(";"):
            cond = self._parse_expr()
            self.expect(";")
        step = None
        if not (self.peek().kind == "punct" and self.peek().text == ")"):
            step = self._parse_expr()
        self.expect(")")
        return For(line=t.line, init=init, cond=cond, step=step,
                   body=self._parse_stmt())

    # -- expressions (precedence climbing) ------------------------------------
    def _parse_expr(self) -> Node:
        e = self._parse_assign()
        while self.accept(","):
            rhs = self._parse_assign()
            e = BinOp(line=e.line, op=",", lhs=e, rhs=rhs)
        return e

    _ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=",
                   "<<=", ">>="}

    def _parse_assign(self) -> Node:
        lhs = self._parse_ternary()
        t = self.peek()
        if t.kind == "punct" and t.text in self._ASSIGN_OPS:
            self.next()
            rhs = self._parse_assign()
            return Assign(line=lhs.line, op=t.text, target=lhs, value=rhs)
        return lhs

    def _parse_ternary(self) -> Node:
        cond = self._parse_binary(0)
        if self.accept("?"):
            a = self._parse_assign()
            self.expect(":")
            b = self._parse_assign()
            return Cond(line=cond.line, cond=cond, then=a, orelse=b)
        return cond

    _LEVELS = (("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
               ("<", ">", "<=", ">="), ("<<", ">>"), ("+", "-"),
               ("*", "/", "%"))

    def _parse_binary(self, level: int) -> Node:
        if level >= len(self._LEVELS):
            return self._parse_unary()
        e = self._parse_binary(level + 1)
        ops = self._LEVELS[level]
        while True:
            t = self.peek()
            if t.kind == "punct" and t.text in ops:
                self.next()
                rhs = self._parse_binary(level + 1)
                e = BinOp(line=e.line, op=t.text, lhs=e, rhs=rhs)
            else:
                return e

    def _parse_unary(self) -> Node:
        t = self.peek()
        if t.kind == "punct" and t.text in ("!", "~", "-", "+", "*", "&",
                                            "++", "--"):
            self.next()
            return UnOp(line=t.line, op=t.text, operand=self._parse_unary())
        if t.kind == "ident" and t.text == "sizeof":
            self.next()
            self.expect("(")
            depth, parts = 1, []
            while depth:
                tok = self.next()
                if tok.kind == "eof":
                    raise ParseError(f"line {t.line}: bad sizeof")
                if tok.kind == "punct" and tok.text == "(":
                    depth += 1
                elif tok.kind == "punct" and tok.text == ")":
                    depth -= 1
                    if not depth:
                        break
                parts.append(tok.text)
            return SizeOf(line=t.line, arg=" ".join(parts))
        if t.kind == "punct" and t.text == "(" and self._is_cast():
            self.next()
            ty = self._parse_type()
            self.expect(")")
            return Cast(line=t.line, type_name=ty,
                        expr=self._parse_unary())
        return self._parse_postfix()

    def _is_cast(self) -> bool:
        """Lookahead: '(' type-only ')' followed by an expression start."""
        j = 1
        saw_type = False
        while True:
            t = self.peek(j)
            if t.kind == "ident" and (t.text in _TYPE_KEYWORDS or
                                      t.text.endswith("_t")):
                saw_type = True
            elif t.kind == "punct" and t.text == "*" and saw_type:
                pass
            elif t.kind == "punct" and t.text == ")":
                nxt = self.peek(j + 1)
                return saw_type and (
                    nxt.kind in ("ident", "num", "str", "char") or
                    (nxt.kind == "punct" and nxt.text in ("(", "*", "&")))
            else:
                return False
            j += 1

    def _parse_postfix(self) -> Node:
        e = self._parse_primary()
        while True:
            t = self.peek()
            if t.kind != "punct":
                return e
            if t.text == "(":
                self.next()
                args: List[Node] = []
                if not self.accept(")"):
                    while True:
                        args.append(self._parse_assign())
                        if not self.accept(","):
                            break
                    self.expect(")")
                e = Call(line=e.line, fn=e, args=args)
            elif t.text == "[":
                self.next()
                idx = self._parse_expr()
                self.expect("]")
                e = Index(line=e.line, base=e, index=idx)
            elif t.text in (".", "->"):
                self.next()
                name = self.next()
                if name.kind != "ident":
                    raise ParseError(f"line {name.line}: expected member")
                e = Member(line=e.line, obj=e, name=name.text,
                           arrow=t.text == "->")
            elif t.text in ("++", "--"):
                self.next()
                e = UnOp(line=e.line, op="post" + t.text, operand=e)
            else:
                return e

    def _parse_primary(self) -> Node:
        t = self.next()
        if t.kind == "num":
            return Num(line=t.line, text=t.text)
        if t.kind == "str":
            # adjacent string literal concatenation
            text = t.text
            while self.peek().kind == "str":
                text += self.next().text
            return Str(line=t.line, text=text)
        if t.kind == "char":
            return Num(line=t.line,
                       text=str(ord(t.text[-1])) if t.text else "0")
        if t.kind == "ident":
            return Ident(line=t.line, name=t.text)
        if t.kind == "punct" and t.text == "(":
            e = self._parse_expr()
            self.expect(")")
            return e
        raise ParseError(f"line {t.line}: unexpected token {t.text!r}")


def parse(src: str) -> Program:
    """Parse C-like source into a ``Program`` (``ParseError`` if not C)."""
    try:
        toks = tokenize(src)
    except LexError as e:
        raise ParseError(str(e)) from e
    return _Parser(toks).parse_program()
