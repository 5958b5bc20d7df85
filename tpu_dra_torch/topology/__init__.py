"""NVLink fabric model and the allocation -> mesh contract (counterpart of
tpu_dra.topology): ``mesh`` (fabric blocks, publish-time validation),
``placement`` (contiguity, ResourceSlice topology views) and
``meshexport`` (claim-env export, MeshPlan)."""
