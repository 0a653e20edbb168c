/* The witness codec: a sequence of integers -> (num_wires, 8) int32 rows,
 * the little-endian u32 limbs of x mod p, byte for byte what
 * `MontCtx.to_limbs_np` makes of the same values, in one pass over the
 * sequence and with no Python object made for a value already reduced.
 *
 * Per value, by what it is:
 *   - an int (or bool) in [0, p): below 2^30 (the 0/1 wires) its one
 *     digit, wider its 30-bit digits re-chunked into 32-bit limbs (nine
 *     at full width), read in place;
 *   - anything else (a negative int, an int >= p, a non-int such as a
 *     numpy integer or a float): int(x) % p through the interpreter.
 *     These values are counted, and the count is the return value.
 * Rows past the sequence's length are zero.
 *
 * The digits are read from the int's object layout, which CPython 3.12
 * and 3.13 share (a tag of sign and digit count, then the digits); on
 * another interpreter the source does not compile, and the caller runs
 * its Python codec.
 *
 * Built at first use by `field/witness_codec.py` and loaded with
 * ctypes.PyDLL: the interpreter lock is held throughout, and an error
 * raised by int(x) or by the remainder is returned as it was raised
 * (-1, with the exception set).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#if PY_VERSION_HEX < 0x030C0000 || PY_VERSION_HEX >= 0x030E0000 || \
    PyLong_SHIFT != 30
#error "the int layout read here is CPython 3.12's and 3.13's, 30-bit digits"
#endif

#define LIMBS 8
#define ROW_BYTES (4 * LIMBS)
#define SIGN_NEGATIVE 2
/* 9 digits of 30 bits hold 270 bits: any int below 2^256 */
#define MAX_DIGITS 9

/* row = the limbs of int x, where x is in [0, 2^256): 1; else 0. */
static int int_limbs(PyObject *x, uint32_t *row)
{
    const PyLongObject *v = (const PyLongObject *)x;
    memset(row, 0, ROW_BYTES);
    if (PyUnstable_Long_IsCompact(v)) {
        Py_ssize_t c = PyUnstable_Long_CompactValue(v);
        row[0] = (uint32_t)c;
        return c >= 0;
    }
    uintptr_t tag = v->long_value.lv_tag;
    size_t nd = tag >> _PyLong_NON_SIZE_BITS;
    if ((tag & _PyLong_SIGN_MASK) == SIGN_NEGATIVE || nd > MAX_DIGITS)
        return 0;
    const digit *d = v->long_value.ob_digit;
    uint64_t acc = 0;
    int bits = 0, k = 0;
    for (size_t i = 0; i < nd; ++i) {
        /* bits < 32 here, so at most one limb is complete per digit */
        acc |= (uint64_t)d[i] << bits;
        bits += PyLong_SHIFT;
        if (bits >= 32) {
            row[k++] = (uint32_t)acc;
            acc >>= 32;
            bits -= 32;
        }
    }
    if (k == LIMBS)
        return acc == 0;
    row[k] = (uint32_t)acc;
    return 1;
}

static int below(const uint32_t *a, const uint32_t *p)
{
    for (int i = LIMBS - 1; i >= 0; --i)
        if (a[i] != p[i])
            return a[i] < p[i];
    return 0;
}

/* row = int(x) % p through the interpreter: 0, or -1 on an error. */
static int reduce_slow(PyObject *x, PyObject *p, uint32_t *row)
{
    PyObject *v = PyNumber_Long(x);
    if (v == NULL)
        return -1;
    PyObject *r = PyNumber_Remainder(v, p);
    Py_DECREF(v);
    if (r == NULL)
        return -1;
    /* 0 <= r < p < 2^256 */
    int ok = int_limbs(r, row);
    Py_DECREF(r);
    if (!ok) {
        PyErr_SetString(PyExc_SystemError, "a remainder outside [0, 2^256)");
        return -1;
    }
    return 0;
}

/* weights: any iterable of integers; p: the modulus, a positive int below
 * 2^256; out: num_wires rows of 8 u32.  Returns how many values took
 * int(x) % p, or -1 with a Python exception set. */
long long zk_witness_limbs(PyObject *weights, Py_ssize_t num_wires,
                           PyObject *p, uint32_t *out)
{
    uint32_t pl[LIMBS];
    if (!PyLong_CheckExact(p) || !int_limbs(p, pl)) {
        PyErr_SetString(PyExc_ValueError, "p must be an int below 2^256");
        return -1;
    }
    PyObject *seq = PySequence_Fast(weights, "weights must be iterable");
    if (seq == NULL)
        return -1;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (n > num_wires) {
        PyErr_Format(PyExc_ValueError, "%zd weights for %zd wires", n,
                     num_wires);
        Py_DECREF(seq);
        return -1;
    }
    PyObject **items = PySequence_Fast_ITEMS(seq);
    long long reduced = 0;
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *x = items[i];
        uint32_t *row = out + (size_t)i * LIMBS;
        if ((PyLong_CheckExact(x) || PyBool_Check(x)) && int_limbs(x, row) &&
            below(row, pl))
            continue;
        if (reduce_slow(x, p, row) < 0) {
            Py_DECREF(seq);
            return -1;
        }
        ++reduced;
    }
    memset(out + (size_t)n * LIMBS, 0, (size_t)(num_wires - n) * ROW_BYTES);
    Py_DECREF(seq);
    return reduced;
}
