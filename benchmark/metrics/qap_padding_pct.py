"""qap_padding_pct: the share of the constraint matrices' product slots
that hold padding, from the program's layout counters
(`zksnark_tpu_torch.utils.profiling.layout_counts`, set by
`compile_r1cs`): the ELL slots past a row's non-zeros over every slot a
prove multiplies (the ELLs' and the wide rows' non-zeros), u, v and w
together.  A program without the counters leaves nothing to read."""


def read(run):
    try:
        from zksnark_tpu_torch.utils import profiling
    except ImportError:
        return None
    counts = getattr(profiling, "layout_counts", dict)()
    slots = counts.get("product_slots")
    return 100.0 * counts["padded_slots"] / slots if slots else None
