"""model.mfu (%): the whole train step's share of the card's dense bf16
peak. Model FLOPs of the traced steps (the family's count: 6 x the
matmul parameters a token passes plus causal attention's matmuls) over
the traced host window, over frozen.PEAKS. None off a known card or
with no device operation in the trace."""


def read(run):
    if not run.kernels or run.peaks is None:
        return None
    flops = run.flops_per_token * run.tokens_per_step * run.steps
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops"]
