"""The race tier (the port's counterpart of hack/race.sh): the steps
``python -m tpu_dra_torch.race [N]`` runs in order (``runner``), each a
function that takes its files and sizes as arguments and returns its
record, ``ok`` its verdict.

1. ``step_lint`` — the port's lint gate, ``python -m
   tpu_dra_torch.analysis --require-justified``;
2. ``step_drmc`` — drmc at a deep budget (600) without the crash matrix,
   exporting its witness's edges;
3. ``step_tsan`` — the domain daemon's TSan build and drive
   (``tsan_drive``);
4. ``step_suites`` — the threaded suites, N times, each run under the
   session witness and view shadow (``plugin``), merging the edges and
   drifts into the same files;
5. ``step_check`` — one ``--check-witness`` / ``--check-view-shadow``
   over the merged exports: every observed edge in the static lock-order
   graph, every drift at a statically implicated view site.

Exports go under build/race/ (gitignored).
"""

# Where the session plugin (``plugin``) merges its witness's edges and its
# view shadow's drifts. Kept here, not in the plugin: importing the
# plugin installs the witness, and this package imports nothing else.
EDGES_ENV = "TPU_DRA_TORCH_RACE_EDGES"
DRIFTS_ENV = "TPU_DRA_TORCH_RACE_DRIFTS"
