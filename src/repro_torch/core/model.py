"""Constraint model AST — the PCCP modelling layer (paper §PCCP).

The PyTorch port's own copy of ``repro/core/model.py`` (pure Python,
kept verbatim apart from ``Model.compile``, which lowers through
``repro_torch.core.compile``).

The paper's PCCP has three statements (ask / tell / parallel) plus a
modelling layer with generators and a compilation function ⟦.⟧ from
constraints to PCCP processes.  We mirror that split:

* this module is the *modelling layer*: integer/boolean variables, linear
  expressions and (reified) linear inequalities, with the paper's reified
  conjunction/equivalence combinators;
* ``compile.py`` is ⟦.⟧ — it lowers every constraint to *guarded commands*
  in a dense tabular form (the guarded normal form of Prop. 4) executable
  by the parallel fixpoint engine.

Everything reduces to one propagator shape,

    b  ⇔  Σ_j a_j · x_j  ≤  c        (ReifLinLe)

with plain inequalities using the always-true variable as ``b``.  This is
exactly the paper's indexical-style compilation: ask on the reif bool,
tell interval tightenings; entailment per its `entailed` function.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# Variable 0 of every model is pinned to (1, 1) and acts as the constant
# `true` of BInc; plain constraints are reified on it.
TRUE_VAR = 0


@dataclasses.dataclass(frozen=True)
class IntVar:
    """Handle to a store index.  Arithmetic builds LinExpr; comparisons
    build constraints (so models read like the paper's examples)."""

    idx: int
    model: "Model" = dataclasses.field(repr=False, compare=False)

    # -- arithmetic sugar → LinExpr -------------------------------------
    def _as_expr(self) -> "LinExpr":
        return LinExpr({self.idx: 1}, 0)

    def __add__(self, other):
        return self._as_expr() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self._as_expr() - other

    def __rsub__(self, other):
        return (-1 * self._as_expr()) + other

    def __mul__(self, k: int):
        return self._as_expr() * k

    __rmul__ = __mul__

    def __neg__(self):
        return self._as_expr() * -1

    def __le__(self, other):
        return self._as_expr() <= other

    def __ge__(self, other):
        return self._as_expr() >= other

    def __lt__(self, other):
        return self._as_expr() < other

    def __gt__(self, other):
        return self._as_expr() > other

    def eq(self, other):
        return self._as_expr().eq(other)


@dataclasses.dataclass
class LinExpr:
    """Σ coef_i · x_i + const, over store indices."""

    terms: Dict[int, int]
    const: int = 0

    @staticmethod
    def of(x) -> "LinExpr":
        if isinstance(x, LinExpr):
            return LinExpr(dict(x.terms), x.const)
        if isinstance(x, IntVar):
            return LinExpr({x.idx: 1}, 0)
        if isinstance(x, (int,)):
            return LinExpr({}, int(x))
        raise TypeError(f"cannot coerce {type(x)} to LinExpr")

    def __add__(self, other):
        o = LinExpr.of(other)
        t = dict(self.terms)
        for v, c in o.terms.items():
            t[v] = t.get(v, 0) + c
        return LinExpr({v: c for v, c in t.items() if c != 0},
                       self.const + o.const)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (LinExpr.of(other) * -1)

    def __rsub__(self, other):
        return LinExpr.of(other) + (self * -1)

    def __mul__(self, k: int):
        k = int(k)
        return LinExpr({v: c * k for v, c in self.terms.items() if c * k != 0},
                       self.const * k)

    __rmul__ = __mul__

    def __neg__(self):
        return self * -1

    # -- comparisons → LinLe --------------------------------------------
    def __le__(self, other) -> "LinLe":
        d = self - other            # d <= 0
        return LinLe(tuple(sorted(d.terms.items())), -d.const)

    def __ge__(self, other) -> "LinLe":
        return LinExpr.of(other) <= self

    def __lt__(self, other) -> "LinLe":
        return self <= (LinExpr.of(other) - 1)

    def __gt__(self, other) -> "LinLe":
        return self >= (LinExpr.of(other) + 1)

    def eq(self, other) -> List["LinLe"]:
        return [self <= other, self >= other]


@dataclasses.dataclass(frozen=True)
class LinLe:
    """Σ a_j x_j ≤ c  (terms sorted by var index, coefficients nonzero)."""

    terms: Tuple[Tuple[int, int], ...]   # ((var, coef), ...)
    rhs: int

    def negated(self) -> "LinLe":
        """¬(Σ a x ≤ c)  ≡  Σ -a x ≤ -c - 1."""
        return LinLe(tuple((v, -c) for v, c in self.terms), -self.rhs - 1)


@dataclasses.dataclass(frozen=True)
class ReifLinLe:
    """b ⇔ (Σ a_j x_j ≤ c).  The linear propagator shape of the engine."""

    bvar: int
    lin: LinLe


@dataclasses.dataclass(frozen=True)
class AllDifferent:
    """alldifferent(x_i + off_i) — native typed propagator (DESIGN.md §12).

    Bounds(Z)-consistent filtering via Hall intervals in the engine; one
    table row replaces the O(n²) reified-disequality decomposition."""

    vars: Tuple[int, ...]
    offsets: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Cumulative:
    """cumulative(s, d, r, c) — native typed propagator (DESIGN.md §12).

    Time-table filtering from compulsory parts in the engine; one table
    row replaces the O(n²) overlap-boolean decomposition (and, with
    capacity 1, the job-shop disjunctive pair encoding)."""

    starts: Tuple[int, ...]
    durations: Tuple[int, ...]
    demands: Tuple[int, ...]
    capacity: int


@dataclasses.dataclass(frozen=True)
class Table:
    """(x₁, …, x_r) ∈ tuples — native extensional propagator
    (DESIGN.md §17).

    Compact-Table filtering over bit-packed finite domains in the
    engine: per variable–value supports as tuple bitsets, a reset-based
    current-table intersection, and domain words filtered by OR-ing the
    surviving supports.  One row replaces the O(|tuples|·arity)
    reified-disjunction decomposition."""

    vars: Tuple[int, ...]
    tuples: Tuple[Tuple[int, ...], ...]


class Model:
    """A PCCP model: local statements (∃x:IZ) + parallel constraint tells."""

    def __init__(self, name: str = "model", dtype_bits: int = 32):
        self.name = name
        self.dtype_bits = dtype_bits
        self.lb0: List[int] = []
        self.ub0: List[int] = []
        self.names: List[str] = []
        self.props: List[ReifLinLe] = []
        self.alldiffs: List[AllDifferent] = []
        self.cumulatives: List[Cumulative] = []
        self.tables: List[Table] = []
        self.objective: Optional[int] = None      # var index to minimize
        self.branch_order: List[int] = []         # decision vars, in order
        # var 0 == constant true
        t = self._new_var(1, 1, "TRUE")
        assert t.idx == TRUE_VAR

    # -- local statements (∃x : IZ, ...) ---------------------------------
    def _new_var(self, lo: int, hi: int, name: str) -> IntVar:
        self.lb0.append(int(lo))
        self.ub0.append(int(hi))
        self.names.append(name)
        return IntVar(len(self.lb0) - 1, self)

    def int_var(self, lo: int, hi: int, name: str = "") -> IntVar:
        if lo > hi:
            raise ValueError(f"empty initial domain for {name}: ({lo},{hi})")
        return self._new_var(lo, hi, name or f"x{len(self.lb0)}")

    def bool_var(self, name: str = "") -> IntVar:
        return self._new_var(0, 1, name or f"b{len(self.lb0)}")

    @property
    def n_vars(self) -> int:
        return len(self.lb0)

    # -- tells (constraint posting) ---------------------------------------
    def add(self, c) -> None:
        """Post a constraint (or a list of them — e.g. from ``eq``)."""
        if isinstance(c, list):
            for ci in c:
                self.add(ci)
        elif isinstance(c, LinLe):
            if not c.terms:               # constant constraint
                if 0 > c.rhs:             # trivially false: post 1 <= 0 on TRUE
                    self.props.append(ReifLinLe(
                        TRUE_VAR, LinLe(((TRUE_VAR, 1),), 0)))
                return
            self.props.append(ReifLinLe(TRUE_VAR, c))
        elif isinstance(c, ReifLinLe):
            self.props.append(c)
        else:
            raise TypeError(f"cannot post {type(c)}")

    def reify(self, lin: LinLe, name: str = "") -> IntVar:
        """∃b:BInc, ⟦b ⇔ lin⟧ — returns b."""
        b = self.bool_var(name or "reif")
        self.props.append(ReifLinLe(b.idx, lin))
        return b

    def iff(self, b: IntVar, lin: LinLe) -> None:
        """⟦b ⇔ lin⟧ for an existing boolean b (paper's ⇔ compilation:
        ask-entailed / ask-disentailed in both directions — realized by the
        single reified propagator which implements all four asks)."""
        self.props.append(ReifLinLe(b.idx, lin))

    def neq(self, a, b) -> None:
        """a ≠ b for linear expressions, via the paper's reified-disjunction
        encoding: b< ⇔ (a < b)  ∥  b> ⇔ (a > b)  ∥  b< + b> ≥ 1.  This is
        the decomposition the model zoo (DESIGN.md §10) uses for all
        disequality/disjunctive constraints so everything stays ReifLinLe."""
        ea, eb = LinExpr.of(a), LinExpr.of(b)
        lt = self.reify(ea < eb, "neq_lt")
        gt = self.reify(ea > eb, "neq_gt")
        self.add(lt + gt >= 1)

    # -- typed global constraints (native propagator table, DESIGN.md §12)

    @property
    def n_constraints(self) -> int:
        """Total propagator-table rows across all kinds."""
        return (len(self.props) + len(self.alldiffs)
                + len(self.cumulatives) + len(self.tables))

    def alldifferent(self, xs: Sequence[IntVar],
                     offsets: Optional[Sequence[int]] = None,
                     decompose: bool = False) -> None:
        """alldifferent(x_i + off_i).

        Default: ONE native `AllDifferent` table row (bounds(Z)-consistent
        Hall-interval filtering in the fixpoint engine).  With
        ``decompose=True`` the pre-§12 lowering is emitted instead — the
        pairwise reified-disequality blowup (3·n·(n-1)/2 `ReifLinLe` rows
        + n·(n-1) fresh booleans) — kept as the parity oracle
        (tests/test_propagators.py).
        """
        offs = [0] * len(xs) if offsets is None else [int(o) for o in offsets]
        if len(offs) != len(xs):
            raise ValueError(f"alldifferent: {len(xs)} vars but "
                             f"{len(offs)} offsets")
        if len(xs) < 2:
            return
        if decompose:
            for i in range(len(xs)):
                for j in range(i + 1, len(xs)):
                    self.neq(xs[i] + offs[i], xs[j] + offs[j])
            return
        self.alldiffs.append(AllDifferent(tuple(x.idx for x in xs),
                                          tuple(offs)))

    def cumulative(self, starts: Sequence[IntVar],
                   durations: Sequence[int], demands: Sequence[int],
                   capacity: int, decompose: bool = False) -> None:
        """cumulative(s, d, r, c): at every time t,
        Σ_{i : s_i ≤ t < s_i + d_i} r_i ≤ c.

        Default: ONE native `Cumulative` table row (time-table filtering
        from compulsory parts).  With ``decompose=True`` the pre-§12
        lowering is emitted instead — the paper's overlap-boolean
        decomposition (Schutt et al. 2009): b_ij ⇔ (s_i ≤ s_j ∧
        s_j ≤ s_i + d_i - 1) plus one capacity row per task — kept as
        the parity oracle.  Capacity 1 is the job-shop disjunctive case.
        """
        n = len(starts)
        d = [int(x) for x in durations]
        r = [int(x) for x in demands]
        if not (len(d) == len(r) == n):
            raise ValueError("cumulative: length mismatch")
        if not decompose:
            self.cumulatives.append(Cumulative(
                tuple(s.idx for s in starts), tuple(d), tuple(r),
                int(capacity)))
            return
        b = [[None] * n for _ in range(n)]
        for i in range(n):
            for j in range(n):
                bij = self.bool_var(f"cu{len(self.cumulatives)}_b{i}_{j}")
                b[i][j] = bij
                if d[i] == 0:
                    self.add(bij <= 0)     # zero-duration: never overlaps
                    continue
                self.iff_and(bij, [starts[i] - starts[j] <= 0,
                                   starts[j] - starts[i] <= d[i] - 1])
        for j in range(n):
            terms = [(r[i], b[i][j]) for i in range(n) if r[i] > 0]
            if not terms:
                continue
            expr = sum((coef * var for coef, var in terms), start=0)
            self.add(expr <= int(capacity))

    def table(self, xs: Sequence[IntVar],
              tuples: Sequence[Sequence[int]],
              decompose: bool = False) -> None:
        """(x₁, …, x_r) ∈ tuples — the extensional (arbitrary-relation)
        constraint.

        Default: ONE native `Table` row, filtered by Compact-Table on
        bit-packed finite domains (DESIGN.md §17).  With
        ``decompose=True`` the reified-disjunction lowering is emitted
        instead — per tuple t, b_t ⇔ ∧_i (x_i = t_i), plus Σ b_t ≥ 1 —
        an O(|tuples|·arity)-row `ReifLinLe` blowup kept as the parity
        oracle (tests/test_compact_table.py).  Tuples with values outside
        a member's initial domain can never be taken and are dropped.
        """
        xs = list(xs)
        if not xs:
            raise ValueError("table: no variables")
        rows = []
        for t in tuples:
            t = tuple(int(v) for v in t)
            if len(t) != len(xs):
                raise ValueError(
                    f"table: tuple {t} has arity {len(t)}, expected "
                    f"{len(xs)}")
            if all(self.lb0[x.idx] <= v <= self.ub0[x.idx]
                   for x, v in zip(xs, t)):
                rows.append(t)
        if not rows:                      # no tuple fits: trivially false
            self.add(LinLe(((TRUE_VAR, 1),), 0))
            return
        if decompose:
            bs = []
            for j, t in enumerate(rows):
                bj = self.bool_var(f"tab{len(self.tables)}_t{j}")
                lins = []
                for x, v in zip(xs, t):
                    lins += [x <= v, x >= v]
                self.iff_and(bj, lins)
                bs.append(bj)
            self.add(sum(bs, LinExpr({}, 0)) >= 1)
            return
        self.tables.append(Table(tuple(x.idx for x in xs), tuple(rows)))

    def iff_and(self, b: IntVar, lins: Sequence[LinLe]) -> None:
        """⟦b ⇔ (φ₁ ∧ ... ∧ φ_m)⟧ via the standard decomposition
        bᵢ ⇔ φᵢ  ∥  b ⇔ ∧ bᵢ  (the conjunction itself compiles to linear:
        b ≤ bᵢ and b ≥ Σ bᵢ - (m-1))."""
        bs = [self.reify(l, name=f"{self.names[b.idx]}&{i}")
              for i, l in enumerate(lins)]
        for bi in bs:
            self.add(b <= bi)                       # b → bᵢ
        self.add(sum(bs, LinExpr({}, 0)) - (len(bs) - 1) <= b)  # ∧bᵢ → b

    # -- search / objective ------------------------------------------------
    def minimize(self, v: IntVar) -> None:
        self.objective = v.idx

    def branch_on(self, vs: Sequence[IntVar]) -> None:
        self.branch_order = [v.idx for v in vs]

    # -- ⟦.⟧ ---------------------------------------------------------------
    def compile(self, **kw):
        from repro_torch.core.compile import compile_model
        return compile_model(self, **kw)
