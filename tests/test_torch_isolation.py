"""The port stands alone: `zksnark_tpu_torch` and `chip_smoke.py` import
neither JAX nor the JAX package, the port's entry points refuse to run on
the CPU unless asked to, and `chip_smoke.py` fails without a card or
without the rest of the repository."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "zksnark_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "zksnark_tpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import zksnark_tpu_torch as z\n"
        "for m in pkgutil.walk_packages(z.__path__, z.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'zksnark_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'zksnark_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert 'zksnark_tpu_torch.groth16.prover' in sys.modules\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_port_sources_import_no_jax():
    files = sorted(p for p in PORT.rglob("*.py")
                   if "_build" not in p.relative_to(PORT).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_refuse_the_cpu_by_default(monkeypatch):
    from zksnark_tpu_torch.frontend.r1cs import R1CS
    from zksnark_tpu_torch.groth16 import prover
    from zksnark_tpu_torch.ops import ntt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r1cs = R1CS(u=[[], [(1, 1)]], v=[[], [(1, 1)]], w=[[(1, 1)], []],
                roots=[1], input=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prover.compile_r1cs(r1cs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ntt.get_domain(3)
    # asking for the CPU works
    assert prover.compile_r1cs(r1cs, device="cpu").n == 2


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_every_kernel_source_is_built():
    from zksnark_tpu_torch import _build

    srcs = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert srcs == set(_build.SOURCES)
    for src, headers in _build.SOURCES.items():
        for h in headers:
            assert (PORT / "csrc" / h).exists()
