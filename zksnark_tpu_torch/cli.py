"""Command-line interface: compile / setup / prove / verify / bench on .zk
circuits.

The port's counterpart of `zksnark_tpu/cli.py`, with both of its flows:

    python -m zksnark_tpu_torch.cli compile circuit.zk
    python -m zksnark_tpu_torch.cli setup   circuit.zk --crs crs.json
    python -m zksnark_tpu_torch.cli prove   circuit.zk --crs crs.json \\
        --inputs 3,2,4 --proof proof.json
    python -m zksnark_tpu_torch.cli verify  circuit.zk --crs crs.json \\
        --proof proof.json --public 2,34
    python -m zksnark_tpu_torch.cli bench   circuit.zk --backend host \\
        --inputs 3,2,4 --public 2,34

--backend device (the default here; the JAX CLI's default is host) runs
the device prover on the CUDA card: the CRS is the JAX package's `.npz`
checkpoint next to --crs (crs.json -> crs.json.npz); `--device cpu` runs
the plain PyTorch versions of the kernels instead (for tests).  It needs
--field bn254, and it has no `bench` (exit 2: the device prover's
benchmark is `python -m zksnark_tpu_torch.bench`).  --backend host runs
the host protocol over the dense-polynomial QAP on the CPU, no kernel
involved, with the JSON CRS at --crs; --field z251 picks the mock
backend there, and `bench` times its setup / prove / verify.

Either package's CLI reads the other's files.  A `.zk` file is read by
the lisp-esque parser when it starts with "(", else by the legacy line
parser.  Exit codes: 0 accept (or done), 1 reject, 2 a usage error or no
card, 3 the witness violates a constraint (--check-witness).
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

    dev = None
    if args.backend == "device":
        if args.command == "bench":
            print("bench times the host protocol (--backend host); the "
                  "device prover's benchmark is python -m "
                  "zksnark_tpu_torch.bench", file=sys.stderr)
            return 2
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

    trapdoor = tuple(_parse_ints(args.trapdoor)) or None
    if args.backend == "device":
        if args.field != "bn254":
            ap.error("--backend device requires --field bn254")
        return _device_flow(args, r1cs, code, field, dev, trapdoor)
    return _host_flow(args, r1cs, code, field, trapdoor)


def _witness(args, r1cs, code, field):
    """The witness of --inputs, or None when --check-witness finds a
    violated gate (after printing them)."""
    from .frontend.witness import weights as mk_weights

    w = mk_weights(code, _parse_ints(args.inputs), field)
    if args.check_witness:
        bad = r1cs.check_satisfied(w, field.p)
        if bad:
            print(f"prove: witness violates {len(bad)} constraint(s) "
                  f"at roots {bad[:8]}{'...' if len(bad) > 8 else ''}")
            return None
    return w


def _host_flow(args, r1cs, code, field, trapdoor) -> int:
    """setup / prove / verify / bench through the host protocol (JSON
    CRS)."""
    from .groth16 import protocol
    from .groth16.backend import BN254Backend, Z251Backend
    from .groth16.qap import from_r1cs
    from .utils import serialization as ser

    be = {"bn254": BN254Backend, "z251": Z251Backend}[args.field]()
    qap = from_r1cs(field, r1cs)

    if args.command == "setup":
        t0 = time.time()
        crs = protocol.setup(be, qap, trapdoor=trapdoor)
        open(args.crs, "w").write(ser.crs_to_json(*crs))
        print(f"setup: wrote {args.crs} ({time.time() - t0:.2f}s)")
        return 0

    if args.command == "prove":
        crs = ser.crs_from_json(open(args.crs).read())
        w = _witness(args, r1cs, code, field)
        if w is None:
            return 3
        t0 = time.time()
        proof = protocol.prove(be, qap, crs, w)
        open(args.proof, "w").write(ser.proof_to_json(proof))
        print(f"prove: wrote {args.proof} ({time.time() - t0:.2f}s)")
        return 0

    if args.command == "verify":
        crs = ser.crs_from_json(open(args.crs).read())
        proof = ser.proof_from_json(open(args.proof).read())
        t0 = time.time()
        ok = protocol.verify(be, crs, _parse_ints(args.public), proof)
        print(f"verify: {'ACCEPT' if ok else 'REJECT'} "
              f"({time.time() - t0:.2f}s)")
        return 0 if ok else 1

    # bench
    from .frontend.witness import weights as mk_weights
    from .utils.profiling import PhaseTimer

    timer = PhaseTimer()
    with timer.phase("setup"):
        crs = protocol.setup(be, qap, trapdoor=trapdoor)
    inputs = _parse_ints(args.inputs) or None
    if inputs is None:
        print("bench: no --inputs given; timing setup only")
        print(timer.report())
        return 0
    w = mk_weights(code, inputs, field)
    with timer.phase("prove"):
        proof = protocol.prove(be, qap, crs, w)
    with timer.phase("verify"):
        ok = protocol.verify(be, crs, _parse_ints(args.public), proof)
    print(timer.report())
    print(f"verify: {'ACCEPT' if ok else 'REJECT'}")
    return 0


def _device_flow(args, r1cs, code, field, dev, trapdoor) -> int:
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
        t0 = time.time()
        dcrs = prover.device_setup(dqap, trapdoor=trapdoor)
        ser.device_crs_save(npz, dcrs)
        print(f"setup(device): wrote {npz} ({time.time() - t0:.2f}s)")
        return 0

    # prove: the witness (and its check) first, then the device
    w = _witness(args, r1cs, code, field)
    if w is None:
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
