"""Model operations of a round's local phase (``bench/work``: the forward,
the activation gradients of the frozen base, the adapters' weight
gradients, the attention pairs the mask keeps, top-k of the experts; no
recomputation) over the window's round time times the card's bf16 peak,
in percent.
The same reading as ``train_mfu``, in the cells that report ``round_s.moe``."""


def read(record):
    peaks = record.get("peaks")
    if peaks is None:
        return None
    return 100.0 * record["work"]["round_flops"] / (record["e2e"]["round_s"] * peaks[1]["bf16"])
