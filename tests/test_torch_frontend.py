"""The port's circuit frontends against the JAX package's, on the CPU.

Every `test_programs/*.zk` compiles to the same R1CS in both packages
(u, v, w, roots, input), in FR and in Z251: the lisp-esque files through
`compiler.parse`, `quad_share.zk` / `cubic_share.zk` through
`legacy.parse`.  `weights` gives the same witness on the same inputs, and
every error case of `tests/test_frontend.py` raises the same exception
class with the same message (and line / gate) in both.  Pure Python;
tolerance: exact equality.
"""

import pathlib

import pytest

from zksnark_tpu.field import host as jhost
from zksnark_tpu.frontend import ast as jast
from zksnark_tpu.frontend import compiler as jcompiler
from zksnark_tpu.frontend import legacy as jlegacy
from zksnark_tpu.frontend import witness as jwitness
from zksnark_tpu_torch.field import host
from zksnark_tpu_torch.frontend import ast, compiler, legacy, witness

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROGRAMS = sorted((ROOT / "test_programs").glob("*.zk"))
LEGACY = ("quad_share.zk", "cubic_share.zk")
FIELDS = {"fr": (host.FR, jhost.FR), "z251": (host.Z251, jhost.Z251)}

QUAD_CODE = """(in x a b c)
(out y)
(verify x y)

(program
    (= t1
        (* x a))
    (= t2
        (* x (+ t1 b)))
    (= y
        (* 1 (+ t2 c))))"""
SIMPLE_CODE = (ROOT / "test_programs" / "simple.zk").read_text()
PROG = "(program (= y (* x x)))"


def _r1cs_fields(r):
    return (r.u, r.v, r.w, r.roots, r.input)


def test_program_files_are_all_covered():
    names = {p.name for p in PROGRAMS}
    assert set(LEGACY) <= names and len(names) == 7


@pytest.mark.parametrize("fname", sorted(FIELDS))
@pytest.mark.parametrize("path", PROGRAMS, ids=lambda p: p.name)
def test_program_r1cs_equal(path, fname):
    mine_f, jax_f = FIELDS[fname]
    code = path.read_text()
    mod, jmod = ((legacy, jlegacy) if path.name in LEGACY
                 else (compiler, jcompiler))
    mine, theirs = mod.parse(code, mine_f), jmod.parse(code, jax_f)
    assert _r1cs_fields(mine) == _r1cs_fields(theirs)
    assert mine.num_wires == theirs.num_wires > 0
    assert mine.num_gates == theirs.num_gates > 0


def _inputs(code, n_mod):
    """Deterministic values for a program's `in` variables."""
    n_in = len(jast.expressions(code, jhost.Z251)[0][1])
    return [(7 * i + 3) % n_mod for i in range(n_in)]


@pytest.mark.parametrize("fname", sorted(FIELDS))
@pytest.mark.parametrize(
    "path", [p for p in PROGRAMS if p.name not in LEGACY],
    ids=lambda p: p.name)
def test_program_weights_equal(path, fname):
    mine_f, jax_f = FIELDS[fname]
    code = path.read_text()
    vals = _inputs(code, 251)
    mine = witness.weights(code, vals, mine_f)
    assert mine == jwitness.weights(code, vals, jax_f)
    r1cs = compiler.parse(code, mine_f)
    assert len(mine) == r1cs.num_wires
    assert r1cs.check_satisfied(mine, mine_f.p) == \
        jcompiler.parse(code, jax_f).check_satisfied(mine, jax_f.p)


def test_weights_golden_and_satisfied():
    w = witness.weights(SIMPLE_CODE, [3, 2, 4], host.Z251)
    assert w == [1, 2, 34, 6, 3, 4]
    assert w == jwitness.weights(SIMPLE_CODE, [3, 2, 4], jhost.Z251)
    r1cs = compiler.parse(SIMPLE_CODE, host.Z251)
    assert r1cs == compiler.parse(SIMPLE_CODE, host.Z251)
    assert r1cs != compiler.parse(QUAD_CODE, host.Z251)
    assert r1cs.check_satisfied(w, 251) == []
    bad = w[:-1] + [(w[-1] + 1) % 251]
    assert r1cs.check_satisfied(bad, 251) == \
        jcompiler.parse(SIMPLE_CODE, jhost.Z251).check_satisfied(bad, 251)
    assert r1cs.check_satisfied(bad, 251)


def test_parse_trees_equal():
    """Tokens, groups, expressions and the variable order of the quad
    program, and the interpreter on a hand-built expression."""
    for f, jf in FIELDS.values():
        assert ast.try_to_list(QUAD_CODE, f) == jast.try_to_list(QUAD_CODE, jf)
        assert ast.expressions(QUAD_CODE, f) == \
            jast.expressions(QUAD_CODE, jf)
        toks = ast.try_to_list(QUAD_CODE, f)
        assert ast.variable_order(toks) == jast.variable_order(toks) == \
            ["x", "y", "t1", "a", "t2", "b", "c"]
        t = ast.try_to_list("y (* 1 (+ t2 c)))", f)
        assert ast.next_group(iter(t)) == jast.next_group(iter(t))
    expr = ("mul", ("lit", 1), ("add", [
        ("mul", ("lit", 4), ("mul", ("var", "a"), ("var", "b"))),
        ("var", "c"), ("mul", ("lit", 6), ("lit", 1))]))
    for env in ({"a": 3, "b": 2}, {"a": 3, "b": 2, "c": 4}):
        assert witness.evaluate(expr, env, host.Z251) == \
            jwitness.evaluate(expr, env, jhost.Z251)
    assert witness.evaluate(expr, {"a": 3, "b": 2, "c": 4}, host.Z251) == 34


@pytest.mark.parametrize("substr", [
    "(in", "(program", "(=", "x", "y))", "9)", "252", "300", "(",
    "(vari(able", "vari(able", "(variable)", "vari=able", "vari*able",
    "vari+able", "(vari=able", "(vari*able", "(vari+able", "9variable",
    "variabl)e))", ")", "()",
])
@pytest.mark.parametrize("fname", sorted(FIELDS))
def test_parse_token_same(substr, fname):
    """Valid tokens equal; invalid ones (Z251 literals >= 251 among them)
    raise ValueError with the same message."""
    f, jf = FIELDS[fname]
    assert _outcome(ast.parse_token, substr, f) == \
        _outcome(jast.parse_token, substr, jf)


def _outcome(fn, *args):
    try:
        out = fn(*args)
        return ("ok", _r1cs_fields(out) if hasattr(out, "roots") else out)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return (type(e).__name__, str(e), getattr(e, "line", None),
                getattr(e, "gate", None))


OUTPUT_TWICE = """(in x)
(out y)
(verify y)

(program
    (= t (* x x))
    (= t (* x x))
    (= y (* t t)))"""
VERIFY_TWICE = """(in x)
(out y)
(verify y)

(program
    (= y (* x x))
    (= y (* x x)))"""
ADD_LHS = """(in x)
(out y)
(verify y)

(program
    (= y (* x (+ (* x 4)))))"""
ADD_RHS = """(in x)
(out y)
(verify y)

(program
    (= y (* x (+ (* 4 5)))))"""
REASSIGN = """(in x)
(out y)
(verify y)

(program
    (= x (* x x)))"""
UNDER = """(in x)
(out y)
(verify y)

(program
    (= y (* x z)))"""

ERROR_CASES = {
    "syntax_line": ("try_to_list", "(in x)\n(out vari(able)"),
    "z251_literal": ("parse", "(in x)\n(out y)\n(verify y)\n"
                     "(program (= y (* x 251)))"),
    "shape_count": ("parse", "(in x)\n(out y)\n(verify x y)"),
    "shape_in": ("parse", f"(out y)\n(in x)\n(verify x)\n{PROG}"),
    "shape_out": ("parse", f"(in x)\n(in x)\n(verify x)\n{PROG}"),
    "shape_verify": ("parse", f"(in x)\n(out y)\n(out y)\n{PROG}"),
    "shape_program": ("parse", "(in x)\n(out y)\n(verify x)\n(verify x)"),
    "output_twice": ("parse", OUTPUT_TWICE),
    "verify_twice": ("parse", VERIFY_TWICE),
    "add_lhs": ("parse", ADD_LHS),
    "add_rhs": ("parse", ADD_RHS),
    "malformed_group": ("parse", "(in x)\n(out y)\n(verify y)\n"
                        "(program (= y (* (in x) x)))"),
    "weights_arity": ("weights", SIMPLE_CODE, [3, 2]),
    "weights_reassign": ("weights", REASSIGN, [3]),
    "weights_under": ("weights", UNDER, [3]),
}


@pytest.mark.parametrize("fname", sorted(FIELDS))
@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_same(case, fname):
    f, jf = FIELDS[fname]
    kind, code, *rest = ERROR_CASES[case]
    fns = {"try_to_list": (ast.try_to_list, jast.try_to_list),
           "parse": (compiler.parse, jcompiler.parse),
           "weights": (witness.weights, jwitness.weights)}[kind]
    args = (code,) + tuple(rest)
    mine = _outcome(fns[0], *args, f)
    theirs = _outcome(fns[1], *args, jf)
    assert mine == theirs
    if not (case == "z251_literal" and fname == "fr"):
        assert mine[0] in ("SyntaxErr", "StructureErr"), mine
    assert issubclass(ast.SyntaxErr, ast.ParseErr)
    assert issubclass(ast.StructureErr, ast.ParseErr)


def test_package_reexports():
    import zksnark_tpu
    import zksnark_tpu_torch as z

    assert _r1cs_fields(z.parse_zk(SIMPLE_CODE)) == \
        _r1cs_fields(zksnark_tpu.parse_zk(SIMPLE_CODE))
    assert z.parse_zk(SIMPLE_CODE, z.FR).roots == [1, 2]
    assert z.weights(SIMPLE_CODE, [3, 2, 4], z.FR) == \
        zksnark_tpu.weights(SIMPLE_CODE, [3, 2, 4], zksnark_tpu.FR)
    assert (z.FR.p, z.FQ.p, z.Z251.p) == (jhost.FR.p, jhost.FQ.p, 251)
    assert isinstance(z.Z251, z.PrimeField)
    for a, b in (([1, 0, 1, 1], 4), ([5, 250], 8)):
        bits = host.to_field_bits(host.Z251, a, b)
        assert bits == jhost.to_field_bits(jhost.Z251, a, b)
        assert host.from_field_bits(host.Z251, bits, b) == a
