"""Share of the MoE expert slots filled (lm.moe.slots_filled over lm.moe.slots) in an LM train step, in %."""
from gbench import spans


def read(rec):
    return spans.counter_pct(rec, "lm.moe.slots_filled", "lm.moe.slots")
