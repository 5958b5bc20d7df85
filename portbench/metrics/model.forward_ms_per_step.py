"""model.forward_ms_per_step (ms): device time per step under the port's
range ``step.forward`` (model.build_train_step: embedding, blocks, head,
loss, the masters' bf16 casts; the ranges inside it included). None
where the trace holds no such range."""

from portbench import ranges


def read(run):
    return ranges.range_ms_per_step(run, "step.forward")
