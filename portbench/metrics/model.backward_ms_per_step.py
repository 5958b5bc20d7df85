"""model.backward_ms_per_step (ms): device time per step under the port's
range ``step.backward`` (model.build_train_step's torch.autograd.grad:
every backward node, launched on autograd's thread while the stepping
thread waits in the range). None where the trace holds no such range."""

from portbench import ranges


def read(run):
    return ranges.range_ms_per_step(run, "step.backward")
