"""model.sgd_ms_per_step (ms): device time per step under the port's
range ``step.sgd`` (model.build_train_step: ``p.sub_`` over every fp32
master). None where the trace holds no such range."""

from portbench import ranges


def read(run):
    return ranges.range_ms_per_step(run, "step.sgd")
