"""Imperative circuit builder: gates, words, comparators, Keccak-256,
and general R1CS constraints with hint wires.

The port's own copy of `zksnark_tpu/builder/circuit.py`.  A circuit is a
set of *sub-circuits*, each multiplying two weighted linear combinations of
wires, plus memoized evaluation, a boolean-gate library and word-level
gadgets.  Evaluation is iterative (an explicit stack), so deep circuits
(Keccak-256: ~232k sub-circuits) hit no recursion limit; wire ids are
dense ints and every iteration order is deterministic.

Beyond the product gates (`new_sub_circuit`: its output is a new wire),
the builder makes general R1CS as libsnark and circom emit it:

- `new_constraint(a, b, c)`: (sum a) * (sum b) = (sum c) with C a given
  linear combination, possibly empty; it makes no wire.
- hint wires (`new_hint`, `new_hints`): wires whose values a function of
  other wires' values sets (libsnark's `generate_r1cs_witness`, circom's
  `<--`), evaluated in build order by `CircuitInstance.weights`; only the
  constraints that mention them bind them.
- the gadgets on top: a private bit check, `pack`, the `lastbits_add`
  modular adder (libsnark's `lastbits_gadget`) and `multipack`
  (libsnark's `multipacking_gadget`); `builder/sha256.py` builds
  SHA256Compress and a Merkle path from them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..field.host import PrimeField
from . import words as W
from .words import Word8, Word64

ZERO_WIRE = 0
UNITY_WIRE = 1

# connection kinds; C_TERM: a term of a constraint's given C
LEFT, RIGHT, OUTPUT, C_TERM = 0, 1, 2, 3
# the bits a field element packs, at most (libsnark's multipacking chunk
# on BN254: 253 bits stay below r)
PACK_BITS = 253


class Circuit:
    """Mutable gate-graph builder over a host field."""

    def __init__(self, field: PrimeField):
        self.field = field
        self.next_wire = 2
        # sub-circuit i: (left_inputs, right_inputs, output_wire); the
        # inputs are [(weight, wire), ...]; a constraint's output is None
        self.subs: List[Tuple[List[Tuple[int, int]],
                              List[Tuple[int, int]], Optional[int]]] = []
        # hint i: (fn, input wires, output wires), in build order; fn maps
        # the inputs' values to the outputs' values
        self.hints: List[Tuple[Callable, List[int], List[int]]] = []
        self.hint_of: Dict[int, int] = {}
        # what sets a wire's value, in build order: a product gate's id,
        # or -1 - i for hint i (`run`)
        self.steps: List[int] = []
        # wire -> list of (kind, weight, sub_circuit_id)
        self.wire_assignments: Dict[int, List[Tuple[int, int, int]]] = {}
        self.wire_values: Dict[int, Optional[int]] = {
            ZERO_WIRE: 0, UNITY_WIRE: field.one()}

    # -- wires --------------------------------------------------------------
    def zero_wire(self) -> int:
        return ZERO_WIRE

    def unity_wire(self) -> int:
        return UNITY_WIRE

    def new_wire(self) -> int:
        wid = self.next_wire
        self.next_wire += 1
        self.wire_values[wid] = None
        return wid

    def num_wires(self) -> int:
        return self.next_wire

    def num_sub_circuits(self) -> int:
        return len(self.subs)

    def new_word8(self) -> Word8:
        return [self.new_wire() for _ in range(8)]

    def new_word8_vec(self, size: int) -> List[Word8]:
        return [self.new_word8() for _ in range(size)]

    def new_word64(self) -> Word64:
        return [self.new_word8() for _ in range(8)]

    def const_wire(self, bit: int) -> int:
        return UNITY_WIRE if bit else ZERO_WIRE

    def const_word8(self, value: int) -> Word8:
        return [self.const_wire((value >> i) & 1) for i in range(8)]

    def const_word64(self, value: int) -> Word64:
        return [self.const_word8((value >> (8 * i)) & 0xFF)
                for i in range(8)]

    # -- assignment ---------------------------------------------------------
    def set_value(self, wire: int, value: int) -> None:
        self.wire_values[wire] = self.field.from_int(value)

    def set_word8(self, wrd: Word8, value: int) -> None:
        for i, wire in enumerate(wrd):
            self.set_value(wire, (value >> i) & 1)

    def set_word64(self, wrd: Word64, value: int) -> None:
        for i, byte in enumerate(wrd):
            self.set_word8(byte, (value >> (8 * i)) & 0xFF)

    def set_new_word8(self, value: int) -> Word8:
        w = self.new_word8()
        self.set_word8(w, value)
        return w

    def set_new_word64(self, value: int) -> Word64:
        w = self.new_word64()
        self.set_word64(w, value)
        return w

    def set_new_word8_vec(self, values: Sequence[int]) -> List[Word8]:
        return [self.set_new_word8(v) for v in values]

    def set_new_word64_vec(self, values: Sequence[int]) -> List[Word64]:
        return [self.set_new_word64(v) for v in values]

    # -- structure ----------------------------------------------------------
    def assignments(self, wire: int) -> List[Tuple[int, int, int]]:
        try:
            return self.wire_assignments[wire]
        except KeyError:
            raise KeyError(
                f"wire {wire} is not defined in this circuit") from None

    def new_sub_circuit(self, left_inputs: List[Tuple[int, int]],
                        right_inputs: List[Tuple[int, int]]) -> int:
        """Register a sub-circuit multiplying two weighted sums; returns its
        output wire."""
        sc_id = len(self.subs)
        out = self.new_wire()
        for weight, wire in left_inputs:
            self.wire_assignments.setdefault(wire, []).append(
                (LEFT, weight, sc_id))
        for weight, wire in right_inputs:
            self.wire_assignments.setdefault(wire, []).append(
                (RIGHT, weight, sc_id))
        self.wire_assignments.setdefault(out, []).append(
            (OUTPUT, self.field.one(), sc_id))
        self.subs.append((list(left_inputs), list(right_inputs), out))
        self.steps.append(sc_id)
        return out

    def _lc(self, terms) -> List[Tuple[int, int]]:
        """A linear combination [(weight, wire)] with each wire once, in
        order of first appearance, weights reduced mod p and zero terms
        dropped."""
        p = self.field.p
        acc: Dict[int, int] = {}
        for weight, wire in terms:
            acc[wire] = (acc.get(wire, 0) + weight) % p
        return [(wt, w) for w, wt in acc.items() if wt]

    def new_constraint(self, a, b, c=()) -> int:
        """Register (sum a) * (sum b) = (sum c), each a list of (weight,
        wire) (any int weights; a wire's terms are merged), C possibly
        empty.  Makes no wire; returns the constraint's sub-circuit id."""
        sc_id = len(self.subs)
        left, right, out = self._lc(a), self._lc(b), self._lc(c)
        for weight, wire in left:
            self.wire_assignments.setdefault(wire, []).append(
                (LEFT, weight, sc_id))
        for weight, wire in right:
            self.wire_assignments.setdefault(wire, []).append(
                (RIGHT, weight, sc_id))
        for weight, wire in out:
            self.wire_assignments.setdefault(wire, []).append(
                (C_TERM, weight, sc_id))
        self.subs.append((left, right, None))
        return sc_id

    def new_hints(self, fn: Callable, inputs: Sequence[int],
                  count: int) -> List[int]:
        """`count` new wires whose values are fn(*input values) (a
        sequence of `count` ints), set when they are evaluated."""
        outs = [self.new_wire() for _ in range(count)]
        h = len(self.hints)
        self.hints.append((fn, list(inputs), outs))
        self.steps.append(-1 - h)
        for o in outs:
            self.hint_of[o] = h
        return outs

    def new_hint(self, fn: Callable, inputs: Sequence[int]) -> int:
        """A new wire whose value is fn(*input values)."""
        return self.new_hints(lambda *v: (fn(*v),), inputs, 1)[0]

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, wire: int) -> int:
        """Memoized wire evaluation, iterative."""
        f = self.field
        stack = [wire]
        while stack:
            wid = stack[-1]
            if wid not in self.wire_values:
                raise KeyError(f"cannot evaluate unknown wire {wid}")
            if self.wire_values[wid] is not None:
                stack.pop()
                continue
            h = self.hint_of.get(wid)
            if h is not None:
                fn, ins, outs = self.hints[h]
                pending = [w for w in ins if self.wire_values.get(w) is None]
                if pending:
                    stack.extend(pending)
                    continue
                vals = fn(*[self.wire_values[w] for w in ins])
                for o, val in zip(outs, vals):
                    self.wire_values[o] = val % f.p
                stack.pop()
                continue
            sc_id = None
            for (kind, _, sc) in self.wire_assignments.get(wid, ()):
                if kind == OUTPUT:
                    sc_id = sc
                    break
            if sc_id is None:
                raise ValueError(
                    f"wire {wid} with unknown value is not the output of "
                    f"a sub circuit")
            left, right, _ = self.subs[sc_id]
            pending = [w for _, w in left + right
                       if self.wire_values.get(w) is None]
            if pending:
                stack.extend(pending)
                continue
            lhs = 0
            for weight, w in left:
                lhs = (lhs + weight * self.wire_values[w]) % f.p
            rhs = 0
            for weight, w in right:
                rhs = (rhs + weight * self.wire_values[w]) % f.p
            self.wire_values[wid] = (lhs * rhs) % f.p
            stack.pop()
        return self.wire_values[wire]

    def evaluate_to_num(self, wires: Sequence[int]) -> int:
        """Evaluate a bit-bundle (Word8/Word64/flat list) to an integer."""
        acc = 0
        one = self.field.one()
        for i, wire in enumerate(_flat_bits(wires)):
            v = self.evaluate(wire)
            if v == one:
                acc |= 1 << i
            elif v != 0:
                raise ValueError(
                    "evaluate_to_num: wire value is neither 0 nor 1")
        return acc

    def evaluate_to_vec(self, stream) -> List[int]:
        return [self.evaluate_to_num(w) for w in stream]

    def run(self) -> None:
        """Set every product gate's output and every hint's wires, in build
        order (each reads only wires made before it), where their inputs
        have values; the rest stay unset for `evaluate` to report."""
        vals, p = self.wire_values, self.field.p
        subs, hints = self.subs, self.hints
        for step in self.steps:
            if step >= 0:
                left, right, out = subs[step]
                if vals[out] is not None:
                    continue
                lhs = rhs = 0
                try:
                    for wt, w in left:
                        lhs += wt * vals[w]
                    for wt, w in right:
                        rhs += wt * vals[w]
                except TypeError:           # an input without a value
                    continue
                vals[out] = lhs * rhs % p
            else:
                fn, ins, outs = hints[-1 - step]
                if vals[outs[0]] is not None:
                    continue
                args = [vals[w] for w in ins]
                if None in args:
                    continue
                for o, val in zip(outs, fn(*args)):
                    vals[o] = val % p

    def reset(self) -> None:
        """Clear wire values except zero/unity so the circuit can be
        re-evaluated on new inputs."""
        for wid in self.wire_values:
            if wid not in (ZERO_WIRE, UNITY_WIRE):
                self.wire_values[wid] = None

    # -- boolean gate library -----------------------------------------------
    def new_bit_checker(self, input_wire: int) -> int:
        """Evaluates to 0 iff the input is 0 or 1: in * (in - 1)."""
        one = self.field.one()
        return self.new_sub_circuit(
            [(one, input_wire)],
            [(one, input_wire), (self.field.neg(one), UNITY_WIRE)])

    def bit_check(self, wires: Sequence[int]) -> List[int]:
        return [self.new_bit_checker(w) for w in wires]

    def new_not(self, input_wire: int) -> int:
        one = self.field.one()
        return self.new_sub_circuit(
            [(one, UNITY_WIRE)],
            [(one, UNITY_WIRE), (self.field.neg(one), input_wire)])

    def new_and(self, lhs: int, rhs: int) -> int:
        one = self.field.one()
        return self.new_sub_circuit([(one, lhs)], [(one, rhs)])

    def new_or(self, lhs: int, rhs: int) -> int:
        one = self.field.one()
        both = self.new_and(lhs, rhs)
        return self.new_sub_circuit(
            [(self.field.neg(one), both), (one, lhs), (one, rhs)],
            [(one, UNITY_WIRE)])

    def new_xor(self, lhs: int, rhs: int) -> int:
        one = self.field.one()
        neg = self.field.neg(one)
        return self.new_sub_circuit(
            [(one, lhs), (neg, rhs)], [(one, lhs), (neg, rhs)])

    def new_nand(self, lhs: int, rhs: int) -> int:
        return self.new_not(self.new_and(lhs, rhs))

    def new_nor(self, lhs: int, rhs: int) -> int:
        one = self.field.one()
        neg = self.field.neg(one)
        ab = self.new_and(lhs, rhs)
        return self.new_sub_circuit(
            [(one, UNITY_WIRE), (one, ab), (neg, lhs), (neg, rhs)],
            [(one, UNITY_WIRE)])

    def new_xnor(self, lhs: int, rhs: int) -> int:
        one = self.field.one()
        neg = self.field.neg(one)
        return self.new_sub_circuit(
            [(one, UNITY_WIRE), (neg, lhs), (one, rhs)],
            [(one, UNITY_WIRE), (one, lhs), (neg, rhs)])

    # -- general R1CS gadgets (libsnark's) ---------------------------------
    def enforce_bit(self, wire: int) -> int:
        """A private bit check: wire * (wire - 1) = 0, no output wire."""
        return self.new_constraint([(1, wire)], [(1, wire), (-1, UNITY_WIRE)])

    def pack(self, bits: Sequence[int]) -> int:
        """A hint wire holding sum 2^i bits[i] (LSB first), bound by one
        packing constraint 1 * (sum 2^i bits[i]) = packed (libsnark's
        `packing_gadget`; the bits are not checked here)."""
        bits = list(bits)
        assert len(bits) <= PACK_BITS, "pack: more bits than a field element"
        packed = self.new_hint(
            lambda *v: sum(x << i for i, x in enumerate(v)), bits)
        self.new_constraint([(1, UNITY_WIRE)],
                            [(1 << i, b) for i, b in enumerate(bits)],
                            [(1, packed)])
        return packed

    def lastbits_add(self, terms, const: int = 0, width: int = 32,
                     carries: int = 2) -> List[int]:
        """Modular addition as libsnark's `lastbits_gadget` makes it: the
        unreduced sum s = sum(weight * wire) + const, terms packed words,
        is unpacked by hints into width + carries bits, bound by one
        packing constraint 1 * (sum 2^i bit_i) = s and a private bit check
        each.  Returns the low `width` bits (LSB first): s mod 2^width.
        The sum must stay below 2^(width + carries)."""
        terms = list(terms)
        total = width + carries
        ws = [wt for wt, _ in terms]

        def split(*vals):
            s = sum(wt * v for wt, v in zip(ws, vals)) + const
            return [(s >> i) & 1 for i in range(total)]

        bits = self.new_hints(split, [w for _, w in terms], total)
        self.new_constraint([(1, UNITY_WIRE)],
                            [(1 << i, b) for i, b in enumerate(bits)],
                            terms + [(const, UNITY_WIRE)])
        for b in bits:
            self.enforce_bit(b)
        return bits[:width]

    def multipack(self, bits: Sequence[int],
                  chunk: int = PACK_BITS) -> List[int]:
        """libsnark's `multipacking_gadget`: the bits (LSB first in each
        chunk) packed `chunk` at a time into field elements; returns the
        packed wires (make them verify wires to publish the bits)."""
        bits = list(bits)
        return [self.pack(bits[i:i + chunk])
                for i in range(0, len(bits), chunk)]

    # -- combinators --------------------------------------------------------
    def fan_in(self, wires: Sequence[int], gate) -> int:
        ws = list(wires)
        if not ws:
            raise ValueError("fan_in: need at least one wire")
        acc = ws[0]
        for w in ws[1:]:
            acc = gate(self, acc, w)
        return acc

    def bitwise_op(self, left: Sequence[int], right: Sequence[int],
                   gate) -> List[int]:
        assert len(left) == len(right)
        return [gate(self, l, r) for l, r in zip(left, right)]

    def u8_bitwise_op(self, left: Word8, right: Word8, gate) -> Word8:
        return [gate(self, l, r) for l, r in zip(left, right)]

    def u64_bitwise_op(self, left: Word64, right: Word64, gate) -> Word64:
        return [self.u8_bitwise_op(lb, rb, gate)
                for lb, rb in zip(left, right)]

    def u8_unary_op(self, wrd: Word8, gate) -> Word8:
        return [gate(self, w) for w in wrd]

    def u64_unary_op(self, wrd: Word64, gate) -> Word64:
        return [self.u8_unary_op(b, gate) for b in wrd]

    def u8_fan_in(self, inputs: Sequence[Word8], gate) -> Word8:
        ws = list(inputs)
        if not ws:
            raise ValueError("u8_fan_in: need at least one Word8")
        acc = ws[0]
        for nxt in ws[1:]:
            acc = self.u8_bitwise_op(acc, nxt, gate)
        return acc

    def u64_fan_in(self, inputs: Sequence[Word64], gate) -> Word64:
        ws = list(inputs)
        if not ws:
            raise ValueError("u64_fan_in: need at least one Word64")
        acc = ws[0]
        for nxt in ws[1:]:
            acc = self.u64_bitwise_op(acc, nxt, gate)
        return acc

    # -- comparators --------------------------------------------------------
    def _new_less_than(self, left: int, right: int) -> int:
        one = self.field.one()
        return self.new_sub_circuit(
            [(one, UNITY_WIRE), (self.field.neg(one), left)],
            [(one, right)])

    def _new_greater_than(self, left: int, right: int) -> int:
        one = self.field.one()
        return self.new_sub_circuit(
            [(one, UNITY_WIRE), (self.field.neg(one), right)],
            [(one, left)])

    def _new_equality(self, left: int, right: int) -> int:
        return self.new_xnor(left, right)

    def is_equal(self, left, right) -> int:
        lw, rw = _flat_bits(left), _flat_bits(right)
        assert len(lw) == len(rw) and lw, "is_equal: length mismatch"
        acc = self._new_equality(lw[0], rw[0])
        for l, r in zip(lw[1:], rw[1:]):
            acc = self.new_and(self._new_equality(l, r), acc)
        return acc

    def is_equal_zero(self, wires) -> int:
        ws = _flat_bits(wires)
        acc = self._new_equality(ws[0], ZERO_WIRE)
        for w in ws[1:]:
            acc = self.new_and(self._new_equality(w, ZERO_WIRE), acc)
        return acc

    def greater_than(self, left, right) -> int:
        """1 iff left > right (unsigned, LSB-first bundles), by folding a
        queue of per-bit comparisons."""
        lw, rw = _flat_bits(left), _flat_bits(right)
        assert len(lw) == len(rw) and lw
        cmp0 = self._new_greater_than(lw[0], rw[0])
        cmps, eqs = [], []
        for l, r in zip(lw[1:], rw[1:]):
            cmps.append(self._new_greater_than(l, r))
            eqs.append(self._new_equality(l, r))
        if not cmps:
            return cmp0
        last_cmp = cmps.pop()
        cmps.insert(0, cmp0)
        acc = last_cmp
        for i, cmp_wire in enumerate(cmps):
            and_eq = self.fan_in(eqs[i:], Circuit.new_and)
            acc = self.new_or(acc, self.new_and(cmp_wire, and_eq))
        return acc

    def less_than(self, left, right) -> int:
        gt = self.greater_than(left, right)
        eq = self.is_equal(left, right)
        return self.new_and(self.new_not(gt), self.new_not(eq))

    def less_than_eq(self, left, right) -> int:
        gt = self.greater_than(left, right)
        eq = self.is_equal(left, right)
        return self.new_or(self.new_not(gt), eq)

    def greater_than_eq(self, left, right) -> int:
        gt = self.greater_than(left, right)
        eq = self.is_equal(left, right)
        return self.new_or(gt, eq)

    # -- Keccak-256 ---------------------------------------------------------
    def keccakf_1600(self, a: List[Word64]) -> None:
        """In-place keccak-f[1600] over a 25-lane state of Word64s."""
        for rnd in range(24):
            # Theta
            array: List[Word64] = [self.const_word64(0) for _ in range(5)]
            for x in range(5):
                for y in range(5):
                    array[x] = self.u64_bitwise_op(
                        array[x], a[x + 5 * y], Circuit.new_xor)
            for x in range(5):
                for y in range(5):
                    a[5 * y + x] = self.u64_fan_in(
                        [a[5 * y + x], array[(x + 4) % 5],
                         W.rotate_word64_left(array[(x + 1) % 5], 1)],
                        Circuit.new_xor)
            # Rho and pi
            last = a[1]
            for x in range(24):
                tmp = a[W.PI[x]]
                a[W.PI[x]] = W.rotate_word64_left(last, W.RHO[x])
                last = tmp
            # Chi
            for y in range(5):
                row = [a[5 * y + x] for x in range(5)]
                for x in range(5):
                    not_ = self.u64_unary_op(row[(x + 1) % 5],
                                             Circuit.new_not)
                    and_ = self.u64_bitwise_op(not_, row[(x + 2) % 5],
                                               Circuit.new_and)
                    a[5 * y + x] = self.u64_bitwise_op(
                        row[x], and_, Circuit.new_xor)
            # Iota
            rc = self.const_word64(W.RC[rnd])
            a[0] = self.u64_bitwise_op(a[0], rc, Circuit.new_xor)

    def _state_bytes(self, a: List[Word64]) -> List[Word8]:
        out: List[Word8] = []
        for lane in a:
            out.extend(lane)
        return out

    def _xorin(self, state: List[Word64], offset: int,
               src: List[Word8]) -> None:
        for i, byte in enumerate(src):
            pos = offset + i
            lane, sub = pos // 8, pos % 8
            state[lane][sub] = self.u8_bitwise_op(
                state[lane][sub], byte, Circuit.new_xor)

    def keccak256(self, input_bytes: List[Word8]) -> List[Word8]:
        """In-circuit Keccak-256 (the original 0x01-padded Keccak, as used
        by Ethereum — NOT NIST SHA3's 0x06), with tiny-keccak's deferred
        padding."""
        rate = 200 - 256 // 4  # 136
        state: List[Word64] = [self.const_word64(0) for _ in range(25)]
        offset = 0
        data = list(input_bytes)
        # absorb
        while len(data) >= rate - offset:
            take = rate - offset
            self._xorin(state, offset, data[:take])
            self.keccakf_1600(state)
            data = data[take:]
            offset = 0
        self._xorin(state, offset, data)
        offset += len(data)
        # pad (deferred, tiny-keccak style) + finalize
        delim = self.const_word8(0x01)
        tail = self.const_word8(0x80)
        state[offset // 8][offset % 8] = self.u8_bitwise_op(
            state[offset // 8][offset % 8], delim, Circuit.new_xor)
        state[(rate - 1) // 8][(rate - 1) % 8] = self.u8_bitwise_op(
            state[(rate - 1) // 8][(rate - 1) % 8], tail, Circuit.new_xor)
        self.keccakf_1600(state)
        # squeeze 32 bytes
        return self._state_bytes(state)[:32]

    def keccak256_stream(self, input_words) -> List[Word8]:
        return self.keccak256(list(input_words))

    # -- 64-bit word arithmetic -------------------------------------------
    def u64_add(self, a: Word64, b: Word64) -> Word64:
        """64-bit ripple-carry addition mod 2^64 (LSB-first wires).

        Per bit, sum = x ^ y ^ c and carry' = (x & y) | (c & (x ^ y)); the
        carry out of bit 63 is dropped."""
        from .words import iter_word64_bits, word64

        out: List[int] = []
        carry = None
        for x, y in zip(iter_word64_bits(a), iter_word64_bits(b)):
            s = self.new_xor(x, y)
            if carry is None:
                out.append(s)
                carry = self.new_and(x, y)
            else:
                out.append(self.new_xor(s, carry))
                carry = self.new_or(self.new_and(x, y),
                                    self.new_and(carry, s))
        return word64(out)

    def u64_sub(self, a: Word64, b: Word64) -> Word64:
        """a - b mod 2^64: two's complement a + ~b + 1 (the +1 rides in
        as the initial carry: sum0 = x ^ ~y ^ 1, carry0 = x | ~y-and-1
        folded algebraically below)."""
        from .words import iter_word64_bits, word64

        out: List[int] = []
        carry = self.unity_wire()  # the +1 of two's complement
        for x, y in zip(iter_word64_bits(a), iter_word64_bits(b)):
            ny = self.new_not(y)
            s = self.new_xor(x, ny)
            out.append(self.new_xor(s, carry))
            carry = self.new_or(self.new_and(x, ny),
                                self.new_and(carry, s))
        return word64(out)

    def validate_balance(self, input_x: Word64, input_y: Word64,
                         input_z: Word64):
        """Balance gadget: commitments to x, y, z plus an in-circuit
        proof that z == x - y (mod 2^64).

        The subtraction is the ripple-carry subtractor above.  Returns
        the ValidateBalance fields."""
        x_hash = self.keccak256_stream(list(input_x))
        y_hash = self.keccak256_stream(list(input_y))
        z_hash = self.keccak256_stream(list(input_z))
        x_min_y = self.u64_sub(input_x, input_y)
        is_z_eq = self.is_equal(input_z, x_min_y)
        return {
            "x_hash": x_hash,
            "y_hash": y_hash,
            "z_hash": z_hash,
            "is_z_eq_x_min_y": is_z_eq,
        }

    def validate_order(self, input_x: Word64, pub_range, input_y: Word64,
                       pub_c: Word64):
        """Range + ordering + hash-commitment gadget."""
        lo, hi = pub_range
        x_geq = self.greater_than_eq(input_x, lo)
        x_leq = self.less_than_eq(input_x, hi)
        in_range = self.new_and(x_geq, x_leq)
        y_geq = self.greater_than_eq(input_y, pub_c)
        hash_x_y = self.keccak256_stream(list(input_x) + list(input_y))
        return {
            "is_x_within_range": in_range,
            "is_y_greater_than_c": y_geq,
            "hash_x_y": hash_x_y,
        }


def _flat_bits(x) -> List[int]:
    """Word8 / Word64 / flat wire list -> flat LSB-first wire list."""
    if not x:
        return []
    if isinstance(x[0], list):
        out: List[int] = []
        for sub in x:
            out.extend(_flat_bits(sub))
        return out
    return list(x)
