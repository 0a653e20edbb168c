"""Command-line interface: compile / setup / prove / verify a .zk circuit on
the card.

The port's counterpart of `zksnark_tpu/cli.py` over its device flow:

    python -m zksnark_tpu_torch.cli compile circuit.zk
    python -m zksnark_tpu_torch.cli setup   circuit.zk --crs crs.json
    python -m zksnark_tpu_torch.cli prove   circuit.zk --crs crs.json \\
        --inputs 3,2,4 --proof proof.json
    python -m zksnark_tpu_torch.cli verify  circuit.zk --crs crs.json \\
        --proof proof.json --public 2,34

The CRS is the JAX package's `.npz` checkpoint, next to --crs (crs.json ->
crs.json.npz), and the proof its JSON, so either package's CLI reads the
other's files.  A `.zk` file is read by the lisp-esque parser when it
starts with "(", else by the legacy line parser.  Exit codes: 0 accept
(or done), 1 reject, 3 the witness violates a constraint
(--check-witness).

It runs on the CUDA card; `--device cpu` runs the plain PyTorch versions
of the kernels instead (for tests).  Not ported yet, and refused: the host
flow (`--backend host`), the Z251 mock backend (`--field z251` beyond
`compile`) and `bench`, which need the host protocol setup / prove, the
QAP and the dense polynomials.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import _device


def _parse_ints(s: str):
    return [int(x, 0) for x in s.split(",")] if s else []


def _load_circuit(path: str, field):
    from .frontend import compiler, legacy

    code = open(path).read()
    if code.lstrip().startswith("("):
        return code, compiler.parse(code, field)
    return code, legacy.parse(code, field)


def _npz_path(crs: str) -> str:
    return crs if crs.endswith(".npz") else crs + ".npz"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zksnark_tpu_torch")
    ap.add_argument("command",
                    choices=["compile", "setup", "prove", "verify", "bench"])
    ap.add_argument("circuit", help=".zk circuit file")
    ap.add_argument("--field", default="bn254", choices=["bn254", "z251"])
    ap.add_argument("--backend", default="device", choices=["host", "device"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                    "the plain versions of the kernels, for tests)")
    ap.add_argument("--crs", default="crs.json")
    ap.add_argument("--proof", default="proof.json")
    ap.add_argument("--inputs", default="", help="private+public inputs, csv")
    ap.add_argument("--public", default="", help="verify-wire values, csv")
    ap.add_argument("--trapdoor", default="",
                    help="pin the 5 toxic-waste values (testing only), csv")
    ap.add_argument("--check-witness", action="store_true",
                    help="check that the witness satisfies every constraint "
                    "before proving (exit 3 if not)")
    args = ap.parse_args(argv)

    if args.command == "bench":
        ap.error("bench is not ported: it times the host protocol setup / "
                 "prove, which need groth16/qap.py and poly/dense.py")
    if args.backend == "host":
        ap.error("--backend host is not ported: it needs the host protocol "
                 "setup / prove, groth16/qap.py and poly/dense.py")
    if args.field == "z251" and args.command != "compile":
        ap.error("--field z251 is not ported beyond compile: it needs the "
                 "Z251 mock backend and the host protocol")

    try:
        dev = _device.resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(2, f"{e}\n")

    from .field.host import FR, Z251

    field = {"bn254": FR, "z251": Z251}[args.field]
    code, r1cs = _load_circuit(args.circuit, field)

    if args.command == "compile":
        print(f"wires={r1cs.num_wires} gates={r1cs.num_gates} "
              f"verify_wires={r1cs.input}")
        return 0
    return _device_flow(args, r1cs, code, field, dev)


def _device_flow(args, r1cs, code, field, dev) -> int:
    """setup / prove / verify through the device prover."""
    from .groth16 import protocol, prover
    from .groth16.backend import BN254Backend
    from .utils import serialization as ser

    npz = _npz_path(args.crs)

    if args.command == "verify":
        crs = ser.host_crs_load(npz)
        proof = ser.proof_from_json(open(args.proof).read())
        t0 = time.time()
        ok = protocol.verify_fast(BN254Backend(), crs,
                                  _parse_ints(args.public), proof)
        print(f"verify: {'ACCEPT' if ok else 'REJECT'} "
              f"({time.time() - t0:.2f}s)")
        return 0 if ok else 1

    if args.command == "setup":
        dqap = prover.compile_r1cs(r1cs, device=dev)
        trapdoor = tuple(_parse_ints(args.trapdoor)) or None
        t0 = time.time()
        dcrs = prover.device_setup(dqap, trapdoor=trapdoor)
        ser.device_crs_save(npz, dcrs)
        print(f"setup(device): wrote {npz} ({time.time() - t0:.2f}s)")
        return 0

    # prove: the witness (and its check) first, then the device
    from .frontend.witness import weights as mk_weights

    w = mk_weights(code, _parse_ints(args.inputs), field)
    if args.check_witness:
        bad = r1cs.check_satisfied(w, field.p)
        if bad:
            print(f"prove: witness violates {len(bad)} constraint(s) "
                  f"at roots {bad[:8]}{'...' if len(bad) > 8 else ''}")
            return 3
    dqap = prover.compile_r1cs(r1cs, device=dev)
    dcrs = ser.device_crs_load(npz, device=dev)
    t0 = time.time()
    proof = prover.device_prove(dqap, dcrs, w)
    open(args.proof, "w").write(ser.proof_to_json(proof))
    print(f"prove(device): wrote {args.proof} ({time.time() - t0:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
