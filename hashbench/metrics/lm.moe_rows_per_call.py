"""(token, held expert) rows the program's MoE layers computed a
``greedy_generate`` call: the change of its counter ``lm.moe_rows`` over
the window, over the calls.  A prefill computes its routed pairs on the
held experts, near tokens × k × held / experts × MoE layers (131,072 for
65,536 prompt tokens at 8 × 12/384 in 8 layers); a decode step, whose
tokens are fewer than the held experts, runs every held expert on them
(12 × batch × 8 a step, at most 2,880 a call).  Far more would be a layer
running all experts on every prompt token."""


def read(rec):
    if not rec.calls or "lm.moe_rows" not in rec.counters:
        return None
    return rec.counter("lm.moe_rows") / rec.calls
