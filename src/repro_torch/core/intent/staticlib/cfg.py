"""Per-function control-flow graph, loop nests and dead-branch folding.

Built on the ``cparse`` AST.  Three products drive the feature analyzer:

* a basic-block CFG (``build_cfg``) used by the reaching-definitions
  dataflow pass,
* the loop-nest table with *symbolic trip counts* — ``for (i = 0;
  i < n; i += k)`` yields the trip expression ``n/k`` (a number when both
  sides fold to constants) — whose nesting depth gives each call its
  structural intensity,
* constant-folded dead branches: statements under ``if (0)`` (or the
  else arm of ``if (1)``) are *excluded* from every downstream analysis,
  which the regex extractor fundamentally cannot do.

A copy of ``repro.core.intent.staticlib.cfg``;
the port imports nothing of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.intent.staticlib import cparse as C


# ---------------------------------------------------------------------------
# constant folding (for dead-branch detection)
# ---------------------------------------------------------------------------
def const_value(expr: Optional[C.Node]) -> Optional[int]:
    """Fold ``expr`` to an int when it is compile-time constant."""
    if isinstance(expr, C.Num):
        return expr.value
    if isinstance(expr, C.UnOp) and expr.op in ("!", "-", "~", "+"):
        v = const_value(expr.operand)
        if v is None:
            return None
        return {"!": lambda x: int(not x), "-": lambda x: -x,
                "~": lambda x: ~x, "+": lambda x: x}[expr.op](v)
    if isinstance(expr, C.BinOp):
        a, b = const_value(expr.lhs), const_value(expr.rhs)
        if expr.op == "&&":
            if a == 0 or b == 0:
                return 0
            if a is not None and b is not None:
                return int(bool(a) and bool(b))
            return None
        if expr.op == "||":
            if a is not None and a != 0:
                return 1
            if b is not None and b != 0:
                return 1
            if a == 0 and b == 0:
                return 0
            return None
        if a is None or b is None:
            return None
        try:
            return {
                "+": a + b, "-": a - b, "*": a * b,
                "/": a // b if b else None, "%": a % b if b else None,
                "&": a & b, "|": a | b, "^": a ^ b,
                "<<": a << b, ">>": a >> b,
                "==": int(a == b), "!=": int(a != b),
                "<": int(a < b), ">": int(a > b),
                "<=": int(a <= b), ">=": int(a >= b),
            }[expr.op]
        except (KeyError, TypeError, ValueError):
            return None
    if isinstance(expr, C.Cast):
        return const_value(expr.expr)
    return None


# ---------------------------------------------------------------------------
# execution contexts: statements annotated with loop/guard/liveness info
# ---------------------------------------------------------------------------
@dataclass
class LoopInfo:
    """One loop of the nest: induction variable, bound, step, trip count."""
    line: int
    var: str = ""
    bound: str = ""           # textual bound expression ("np", "nfiles", ...)
    step: str = "1"           # textual step ("1", "xfer", ...)
    trip: Optional[int] = None    # folded trip count when constant
    trip_sym: str = ""        # symbolic trip expression, e.g. "block/xfer"
    depth: int = 1


@dataclass
class StmtCtx:
    """Execution context of one statement (pre-order walk)."""
    stmt: C.Node
    order: int                 # statement sequence index (pre-order)
    loops: Tuple[LoopInfo, ...] = ()
    guard_div: int = 1         # modulus/bitmask divisor of enclosing ifs
    dead: bool = False         # under a constant-false branch
    cond_depth: int = 0        # number of enclosing non-constant if arms

    @property
    def depth(self) -> int:
        """Loop-nest depth of the statement."""
        return len(self.loops)


def _expr_text(e: Optional[C.Node]) -> str:
    """Compact textual rendering of an expression (for symbolic trips)."""
    if e is None:
        return ""
    if isinstance(e, C.Num):
        return e.text
    if isinstance(e, C.Str):
        return f'"{e.text}"'
    if isinstance(e, C.Ident):
        return e.name
    if isinstance(e, C.Call):
        return f"{_expr_text(e.fn)}({', '.join(map(_expr_text, e.args))})"
    if isinstance(e, C.BinOp):
        return f"{_expr_text(e.lhs)}{e.op}{_expr_text(e.rhs)}"
    if isinstance(e, C.UnOp):
        if e.op.startswith("post"):
            return f"{_expr_text(e.operand)}{e.op[4:]}"
        return f"{e.op}{_expr_text(e.operand)}"
    if isinstance(e, C.Assign):
        return f"{_expr_text(e.target)}{e.op}{_expr_text(e.value)}"
    if isinstance(e, C.Member):
        return f"{_expr_text(e.obj)}{'->' if e.arrow else '.'}{e.name}"
    if isinstance(e, C.Index):
        return f"{_expr_text(e.base)}[{_expr_text(e.index)}]"
    if isinstance(e, C.Cast):
        return f"({e.type_name}){_expr_text(e.expr)}"
    if isinstance(e, C.SizeOf):
        return f"sizeof({e.arg})"
    if isinstance(e, C.Cond):
        return (f"{_expr_text(e.cond)}?{_expr_text(e.then)}"
                f":{_expr_text(e.orelse)}")
    return "?"


def _loop_info(node: C.Node, depth: int) -> LoopInfo:
    info = LoopInfo(line=node.line, depth=depth)
    if isinstance(node, C.For):
        # induction variable from init
        if isinstance(node.init, C.Decl):
            info.var = node.init.name
        elif isinstance(node.init, C.ExprStmt) and \
                isinstance(node.init.expr, C.Assign) and \
                isinstance(node.init.expr.target, C.Ident):
            info.var = node.init.expr.target.name
        # bound from "var < bound" condition
        if isinstance(node.cond, C.BinOp) and node.cond.op in ("<", "<=",
                                                              "!=", ">"):
            lhs, rhs = node.cond.lhs, node.cond.rhs
            if isinstance(lhs, C.Ident) and lhs.name == info.var:
                info.bound = _expr_text(rhs)
            elif isinstance(rhs, C.Ident) and rhs.name == info.var:
                info.bound = _expr_text(lhs)
        # step from "var++" / "var += k"
        step = node.step
        if isinstance(step, C.UnOp) and step.op in ("++", "post++",
                                                    "--", "post--"):
            info.step = "1"
        elif isinstance(step, C.Assign) and step.op in ("+=", "-="):
            info.step = _expr_text(step.value)
        # symbolic trip count bound/step, folded when constant
        if info.bound:
            info.trip_sym = (info.bound if info.step == "1"
                             else f"({info.bound})/({info.step})")
            try:
                lo = 0
                if isinstance(node.init, C.Decl) and node.init.init:
                    lo = const_value(node.init.init) or 0
                hi = const_value(node.cond.rhs) \
                    if isinstance(node.cond, C.BinOp) else None
                stp = 1 if info.step == "1" else int(info.step, 0)
                if hi is not None and stp:
                    info.trip = max(0, (hi - lo + stp - 1) // stp)
            except (ValueError, AttributeError, TypeError):
                info.trip = None
    elif isinstance(node, C.While):
        info.trip_sym = _expr_text(node.cond)
    return info


def _guard_divisor(cond: C.Node) -> int:
    """Sampling divisor of a guard like ``i % 8 == 0`` / ``(i & 15) == 0``.

    Returns 1 when the guard is not a recognizable sampling condition.
    """
    if isinstance(cond, C.BinOp) and cond.op == "==":
        inner, cst = cond.lhs, const_value(cond.rhs)
        if cst is None:
            inner, cst = cond.rhs, const_value(cond.lhs)
        if cst == 0 and isinstance(inner, C.BinOp):
            if inner.op == "%":
                k = const_value(inner.rhs)
                return k if k and k > 1 else 1
            if inner.op == "&":
                k = const_value(inner.rhs)
                return k + 1 if k and k > 0 else 1
    return 1


def walk_contexts(func: C.FuncDef) -> List[StmtCtx]:
    """Pre-order statement contexts of a function body.

    Every statement (including those inside dead branches, which are
    marked ``dead=True``) appears once, with its loop nest, guard
    divisor and liveness resolved.
    """
    out: List[StmtCtx] = []
    counter = [0]

    def visit(node: C.Node, loops: Tuple[LoopInfo, ...], div: int,
              dead: bool, cond: int) -> None:
        if node is None:
            return
        ctx = StmtCtx(node, counter[0], loops, div, dead, cond)
        counter[0] += 1
        out.append(ctx)
        if isinstance(node, C.Block):
            for s in node.stmts:
                visit(s, loops, div, dead, cond)
        elif isinstance(node, (C.For, C.While)):
            info = _loop_info(node, len(loops) + 1)
            if isinstance(node, C.For) and node.init is not None:
                visit(node.init, loops, div, dead, cond)
            visit(node.body, loops + (info,), div, dead, cond)
        elif isinstance(node, C.If):
            cv = const_value(node.cond)
            gd = _guard_divisor(node.cond)
            visit(node.then, loops, div * gd, dead or cv == 0,
                  cond + (cv is None))
            if node.orelse is not None:
                visit(node.orelse, loops, div,
                      dead or (cv is not None and cv != 0),
                      cond + (cv is None))

    visit(func.body, (), 1, False, 0)
    return out


def loop_nests(func: C.FuncDef) -> List[LoopInfo]:
    """All loops of a function with depth and symbolic trip counts."""
    seen: Dict[int, LoopInfo] = {}
    for ctx in walk_contexts(func):
        for info in ctx.loops:
            seen.setdefault(id(info), info)
    return list(seen.values())


# ---------------------------------------------------------------------------
# basic-block CFG (for the reaching-definitions pass)
# ---------------------------------------------------------------------------
@dataclass
class BasicBlock:
    """A straight-line run of simple statements with successor edges."""
    bid: int
    stmts: List[C.Node] = field(default_factory=list)
    succs: List[int] = field(default_factory=list)


@dataclass
class CFG:
    """Control-flow graph of one function."""
    func: C.FuncDef
    blocks: List[BasicBlock] = field(default_factory=list)
    entry: int = 0
    exit: int = 0

    def block(self) -> BasicBlock:
        """Append and return a fresh empty basic block."""
        b = BasicBlock(len(self.blocks))
        self.blocks.append(b)
        return b

    def iter_stmts(self) -> Iterator[C.Node]:
        """All simple statements in block order."""
        for b in self.blocks:
            yield from b.stmts


def build_cfg(func: C.FuncDef) -> CFG:
    """Lower a function body to a basic-block CFG.

    Dead branches (constant-false conditions) get no edge from their
    predecessor, so reaching-definitions never propagates through them.
    """
    cfg = CFG(func)
    entry = cfg.block()
    cfg.entry = entry.bid

    def lower(node: C.Node, cur: BasicBlock) -> BasicBlock:
        if node is None:
            return cur
        if isinstance(node, C.Block):
            for s in node.stmts:
                cur = lower(s, cur)
            return cur
        if isinstance(node, C.If):
            cv = const_value(node.cond)
            join = cfg.block()
            if cv != 0:                       # then arm reachable
                tb = cfg.block()
                cur.succs.append(tb.bid)
                lower(node.then, tb).succs.append(join.bid)
            if node.orelse is not None and (cv is None or cv == 0):
                eb = cfg.block()
                cur.succs.append(eb.bid)
                lower(node.orelse, eb).succs.append(join.bid)
            if node.orelse is None and cv != 1:
                cur.succs.append(join.bid)    # fallthrough
            if not cur.succs:
                cur.succs.append(join.bid)
            return join
        if isinstance(node, (C.For, C.While)):
            if isinstance(node, C.For) and node.init is not None:
                cur = lower(node.init, cur)
            head = cfg.block()
            cur.succs.append(head.bid)
            body = cfg.block()
            head.succs.append(body.bid)
            end = lower(node.body, body)
            if isinstance(node, C.For) and node.step is not None:
                end.stmts.append(C.ExprStmt(line=node.step.line,
                                            expr=node.step))
            end.succs.append(head.bid)        # back edge
            after = cfg.block()
            head.succs.append(after.bid)
            return after
        if isinstance(node, (C.Return, C.Jump)):
            cur.stmts.append(node)
            return cur
        cur.stmts.append(node)
        return cur

    last = lower(func.body, entry)
    cfg.exit = last.bid
    return cfg
