"""The port's e2e tier (counterpart of hack/e2e.sh, tests/e2e/run.sh and
its ten shell suites): Python suites against a SimCluster with the
chart installed, no shell and no kubectl.

Run: ``python -m tpu_dra_torch.e2e [SUITE ...] [--fast] [--card-node]
[--keep-going]`` (see __main__).
"""
