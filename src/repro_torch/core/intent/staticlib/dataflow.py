"""Dataflow analyses over the C-like AST/CFG: rank taint + offset evolution.

Two analyses feed the feature analyzer:

* **rank-taint propagation** — a small taint lattice ``NONE < SELF <
  OTHER < ALL`` tracks how the MPI rank flows through assignments and
  ``sprintf``-style name construction.  ``rank`` is SELF; ``rank ± c``
  and ``(rank + c) % np`` are OTHER (a *different* rank's identity); a
  loop variable sweeping ``0..np`` is ALL.  A SELF-tainted filename
  means file-per-process (N-N); OTHER/ALL taint reaching a read's
  filename or offset means cross-rank reads; taint that never reaches a
  filename while a shared handle is indexed across ranks means N-1.

* **offset evolution** — each data call's access pattern is classified
  from the *reaching definitions* of its offset argument (a classic
  worklist RD pass over the basic-block CFG), not from regex guesses:
  ``off += xfer`` in a loop is ``seq``; ``off += np * xfer`` is
  ``strided``; offsets derived from PRNG-style calls or non-affine
  ``%`` arithmetic are ``random``.

A copy of ``repro.core.intent.staticlib.dataflow``;
the port imports nothing of the reference.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.intent.staticlib import cparse as C
from repro_torch.core.intent.staticlib.cfg import CFG, const_value

# taint lattice, ordered
TAINT_NONE, TAINT_SELF, TAINT_OTHER, TAINT_ALL = 0, 1, 2, 3
_TAINT_NAMES = {TAINT_NONE: "none", TAINT_SELF: "self",
                TAINT_OTHER: "other", TAINT_ALL: "all"}

RANK_NAMES = {"rank", "myrank", "my_rank", "me", "mpi_rank"}
NPROC_NAMES = {"np", "nprocs", "nproc", "size", "world_size", "comm_size"}


def taint_name(t: int) -> str:
    """Human-readable lattice point name."""
    return _TAINT_NAMES.get(t, "?")


def join(a: int, b: int) -> int:
    """Lattice join (max)."""
    return max(a, b)


def free_idents(e: Optional[C.Node]) -> Set[str]:
    """Free identifier names of an expression (callee names excluded)."""
    out: Set[str] = set()

    def go(n):
        if isinstance(n, C.Ident):
            out.add(n.name)
        elif isinstance(n, C.Call):
            if not isinstance(n.fn, C.Ident):
                go(n.fn)
            for a in n.args:
                go(a)
        elif isinstance(n, C.BinOp):
            go(n.lhs)
            go(n.rhs)
        elif isinstance(n, (C.UnOp, C.Cast)):
            go(n.operand if isinstance(n, C.UnOp) else n.expr)
        elif isinstance(n, C.Assign):
            go(n.target)
            go(n.value)
        elif isinstance(n, C.Member):
            go(n.obj)
        elif isinstance(n, C.Index):
            go(n.base)
            go(n.index)
        elif isinstance(n, C.Cond):
            go(n.cond)
            go(n.then)
            go(n.orelse)

    go(e)
    return out


def calls_in(e: Optional[C.Node]) -> List[C.Call]:
    """All call expressions inside ``e`` (pre-order)."""
    out: List[C.Call] = []

    def go(n):
        if isinstance(n, C.Call):
            out.append(n)
            for a in n.args:
                go(a)
        elif isinstance(n, C.BinOp):
            go(n.lhs)
            go(n.rhs)
        elif isinstance(n, C.UnOp):
            go(n.operand)
        elif isinstance(n, C.Cast):
            go(n.expr)
        elif isinstance(n, C.Assign):
            go(n.target)
            go(n.value)
        elif isinstance(n, C.Member):
            go(n.obj)
        elif isinstance(n, C.Index):
            go(n.base)
            go(n.index)
        elif isinstance(n, C.Cond):
            go(n.cond)
            go(n.then)
            go(n.orelse)

    go(e)
    return out


# ---------------------------------------------------------------------------
# taint evaluation
# ---------------------------------------------------------------------------
class TaintEnv:
    """Variable → taint map with loop-variable awareness."""

    def __init__(self, loop_all_vars: Optional[Set[str]] = None):
        self.vars: Dict[str, int] = {}
        self.loop_all_vars = loop_all_vars or set()

    def copy(self) -> "TaintEnv":
        """Shallow copy sharing the loop-var set."""
        env = TaintEnv(self.loop_all_vars)
        env.vars = dict(self.vars)
        return env

    def get(self, name: str) -> int:
        """Taint of a variable, joined with its structural seeds.

        Seeds (rank names are SELF, loop vars sweeping ``0..np`` are
        ALL) join with — rather than being masked by — assignments, so
        a ``for (int r = 0; r < np; r++)`` init cannot launder the
        loop variable down to untainted.
        """
        t = self.vars.get(name, TAINT_NONE)
        if name in RANK_NAMES:
            t = join(t, TAINT_SELF)
        if name in self.loop_all_vars:
            t = join(t, TAINT_ALL)
        return t

    def set(self, name: str, taint: int, weak: bool = False) -> None:
        """Bind (``weak=True`` joins with the existing value)."""
        if weak:
            taint = join(taint, self.get(name))
        self.vars[name] = taint


def eval_taint(e: Optional[C.Node], env: TaintEnv) -> int:
    """Taint of an expression under ``env``.

    The interesting transfer rules: ``self ± nonzero-const → other``
    (a neighbor's identity), ``x % np`` keeps plain ``rank`` SELF but
    promotes shifted ranks to OTHER, and any operand at ALL wins.
    """
    if e is None:
        return TAINT_NONE
    if isinstance(e, (C.Num, C.Str, C.SizeOf)):
        return TAINT_NONE
    if isinstance(e, C.Ident):
        return env.get(e.name)
    if isinstance(e, C.Cast):
        return eval_taint(e.expr, env)
    if isinstance(e, C.UnOp):
        return eval_taint(e.operand, env)
    if isinstance(e, C.Member):
        return eval_taint(e.obj, env)
    if isinstance(e, C.Index):
        return join(eval_taint(e.base, env), TAINT_NONE)
    if isinstance(e, C.Assign):
        return eval_taint(e.value, env)
    if isinstance(e, C.Cond):
        return join(eval_taint(e.then, env), eval_taint(e.orelse, env))
    if isinstance(e, C.Call):
        t = TAINT_NONE
        for a in e.args:
            t = join(t, eval_taint(a, env))
        return t
    if isinstance(e, C.BinOp):
        lt, rt = eval_taint(e.lhs, env), eval_taint(e.rhs, env)
        t = join(lt, rt)
        if e.op in ("+", "-") and t == TAINT_SELF:
            # rank shifted by a nonzero amount names ANOTHER rank
            other = e.rhs if lt == TAINT_SELF else e.lhs
            cv = const_value(other)
            if cv is None or cv != 0:
                if free_idents(other) or (cv is not None and cv != 0):
                    return TAINT_OTHER
        if e.op == "%" and t >= TAINT_SELF and \
                free_idents(e.rhs) & NPROC_NAMES:
            # (rank) % np is still self; (rank ± c) % np is other
            if isinstance(e.lhs, (C.Ident, C.Cast)) and t == TAINT_SELF:
                return TAINT_SELF
            return max(t, TAINT_OTHER)
        return t
    return TAINT_NONE


# ---------------------------------------------------------------------------
# reaching definitions (worklist over the basic-block CFG)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Def:
    """One definition site: variable, defining node id, compound flag."""
    var: str
    node_id: int
    compound: bool          # from "v op= expr" (loop-carried update)


class ReachingDefs:
    """Classic forward may-analysis: which defs reach each block."""

    def __init__(self, cfg: CFG):
        self.cfg = cfg
        self.defs_by_id: Dict[int, Tuple[Def, C.Node]] = {}
        self.block_in: Dict[int, Set[Def]] = {}
        self._run()

    def _stmt_defs(self, stmt: C.Node) -> List[Tuple[Def, C.Node]]:
        out = []
        if isinstance(stmt, C.Decl) and stmt.init is not None:
            out.append((Def(stmt.name, id(stmt), False), stmt.init))
        exprs = []
        if isinstance(stmt, C.ExprStmt):
            exprs.append(stmt.expr)
        for e in exprs:
            # assignments possibly chained/nested
            stack = [e]
            while stack:
                n = stack.pop()
                if isinstance(n, C.Assign):
                    if isinstance(n.target, C.Ident):
                        out.append((Def(n.target.name, id(n),
                                        n.op != "="), n.value))
                    stack.append(n.value)
                elif isinstance(n, C.BinOp):
                    stack.extend((n.lhs, n.rhs))
                elif isinstance(n, C.UnOp):
                    if n.op in ("++", "--", "post++", "post--") and \
                            isinstance(n.operand, C.Ident):
                        out.append((Def(n.operand.name, id(n), True),
                                    n.operand))
                    stack.append(n.operand)
        return out

    def _run(self) -> None:
        cfg = self.cfg
        gen: Dict[int, Dict[str, Set[Def]]] = {}
        for b in cfg.blocks:
            g: Dict[str, Set[Def]] = {}
            for s in b.stmts:
                for d, val in self._stmt_defs(s):
                    self.defs_by_id[d.node_id] = (d, val)
                    if d.compound:
                        g.setdefault(d.var, set()).add(d)
                    else:
                        g[d.var] = {d}
            gen[b.bid] = g
        preds: Dict[int, List[int]] = {b.bid: [] for b in cfg.blocks}
        for b in cfg.blocks:
            for s in b.succs:
                preds[s].append(b.bid)
        out: Dict[int, Set[Def]] = {b.bid: set() for b in cfg.blocks}
        self.block_in = {b.bid: set() for b in cfg.blocks}
        changed = True
        while changed:
            changed = False
            for b in cfg.blocks:
                in_set: Set[Def] = set()
                for p in preds[b.bid]:
                    in_set |= out[p]
                self.block_in[b.bid] = in_set
                killed_vars = {v for v, ds in gen[b.bid].items()
                               if any(not d.compound for d in ds)}
                new_out = {d for d in in_set if d.var not in killed_vars}
                for ds in gen[b.bid].values():
                    new_out |= ds
                if new_out != out[b.bid]:
                    out[b.bid] = new_out
                    changed = True

    def reaching(self, var: str) -> List[Tuple[Def, C.Node]]:
        """Every definition of ``var`` anywhere in the function."""
        return [(d, v) for d, v in self.defs_by_id.values() if d.var == var]


# ---------------------------------------------------------------------------
# offset-evolution classification
# ---------------------------------------------------------------------------
def classify_offset(expr: Optional[C.Node], rd: ReachingDefs,
                    loop_vars: Dict[str, str]) -> Tuple[str, str]:
    """Access-pattern class of a data call's offset argument.

    ``loop_vars`` maps enclosing induction variables to their step text.
    Returns ``(pattern, why)`` with pattern in seq/strided/random/unknown.
    """
    if expr is None:
        return "seq", "no offset argument (stream advance)"
    roots = free_idents(expr)
    # direct structure: PRNG → random; other opaque calls → unknown
    direct_calls = calls_in(expr)
    for call in direct_calls:
        if "rand" in call.name.lower():
            return "random", f"offset from PRNG call {call.name}()"
    if direct_calls:
        if _contains_mod(expr):
            return "random", "opaque call folded through non-np %"
        return "unknown", (f"offset from opaque call "
                           f"{direct_calls[0].name}()")
    verdicts: List[Tuple[str, str]] = []

    def visit_value(val: C.Node, why: str, depth: int = 0) -> None:
        if depth > 3:
            return
        idents = free_idents(val)
        for call in calls_in(val):
            if "rand" in call.name.lower():
                verdicts.append(("random",
                                 f"{why} ← PRNG call {call.name}()"))
                return
        has_mod = _contains_mod(val)
        has_call = bool(calls_in(val))
        if has_call and has_mod:
            verdicts.append(("random", f"{why} ← opaque call folded "
                                       "through %"))
            return
        if has_call:
            verdicts.append(("unknown", f"{why} ← opaque call"))
            return
        if idents & NPROC_NAMES:
            verdicts.append(("strided", f"{why} advances by a multiple "
                                        "of np"))
            return

    for r in sorted(roots):
        for d, val in rd.reaching(r):
            why = f"def of {r!r}"
            if d.compound:
                step_ids = free_idents(val)
                if step_ids & NPROC_NAMES:
                    verdicts.append(
                        ("strided", f"{r} += step involving np"))
                else:
                    verdicts.append(("seq", f"{r} += constant stride"))
            else:
                visit_value(val, why)
        if r in loop_vars:
            # affine use of an induction variable: step decides the class
            step_ids = set(re.findall(r"[A-Za-z_]\w*", loop_vars[r]))
            if step_ids & NPROC_NAMES:
                verdicts.append(("strided",
                                 f"loop var {r!r} steps by np"))
            else:
                verdicts.append(("seq", f"affine in loop var {r!r}"))
    order = ("random", "strided", "seq")
    for pat in order:
        for v, why in verdicts:
            if v == pat:
                return pat, why
    if roots and all(not rd.reaching(r) and r not in loop_vars
                     for r in roots):
        # loop-invariant parameter/constant offset: one contiguous slab
        return "seq", "loop-invariant offset (contiguous slab)"
    return "unknown", "offset provenance not resolved"


def _contains_mod(e: Optional[C.Node]) -> bool:
    if isinstance(e, C.BinOp):
        if e.op == "%" and not (free_idents(e.rhs) & NPROC_NAMES):
            return True
        return _contains_mod(e.lhs) or _contains_mod(e.rhs)
    if isinstance(e, (C.UnOp,)):
        return _contains_mod(e.operand)
    if isinstance(e, C.Cast):
        return _contains_mod(e.expr)
    if isinstance(e, C.Assign):
        return _contains_mod(e.value)
    if isinstance(e, C.Call):
        return any(_contains_mod(a) for a in e.args)
    return False
