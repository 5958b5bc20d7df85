#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_dra_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line ({"phase": ...}):

1. probe        — the card (nvidia-smi name and power limit, torch name
                  and compute capability, expected (9, 0)) and nvcc's
                  version;
2. build        — compiles the four flash-attention kernels from
                  tpu_dra_torch/workloads/csrc with nvcc for sm_90a and,
                  beside them, the native domain daemon from
                  tpu_dra_torch/native/src with c++;
   Then, before this process opens a CUDA context (under
   EXCLUSIVE_PROCESS an MPS server could not open its own beside it), on
   the GPU torch calls cuda:0 as NVML lists it:
   shared_claim — tpu_dra_torch.bench.bench_shared_claim: one
                  default-config claim prepared with NodePrepareResources
                  over the framed socket of a GpuDriver (NativeBackend, a
                  FakeCluster); one solo claim child, then two at once,
                  each one warm step, then bench.SHARED_STEPS timed steps
                  started together on the parent's "go": both windows
                  overlap for >= 90% of each one's length, both on the
                  claim's UUID, finite losses, n_layers x steps launches
                  of flash_fwd_sm90 and flash_bwd_sm90 and none of the
                  mma.sync kernels in every child, 2 x the solo peak
                  within the GPU's memory, and unprepare leaves no spec
                  and no checkpoint entry; each child's median step and
                  the two's tokens/s against the solo child's;
   mps          — the same two children on an MPS claim (50% active
                  threads, a pinned limit of 1.5 x the solo peak in whole
                  GiB), the card's nvidia-cuda-mps-control run by
                  tpu_dra_torch.testing.MpsNodeSim; one of (a) the binary
                  is not on PATH, (b) NVML refuses the compute mode and
                  the prepare unwinds (no Deployment, daemon process,
                  spec or checkpoint entry; compute mode DEFAULT), or (c)
                  both children are the daemon's clients during their
                  windows and everything of shared_claim holds;
   mig          — read-only: MIG mode, and NVML's GPU-instance profiles
                  and placements against the H100 table; only where MIG
                  mode is already on, a 3g.40gb claim with one child on
                  its MIG- UUID and no instance left after unprepare;
   passthrough  — read-only: the GPU's sysfs function, driver, IOMMU
                  group and whether vfio_pci is loaded; never rebound;
3. kernels      — each kernel against its plain PyTorch version on the
                  card, on the same bf16 inputs (q, k, v views of one
                  fused projection, as the model passes them), at small
                  shapes (S=40, 320 and 384, causal and not, rope and
                  not, and S=1023 causal, at D=64 and 128: every branch
                  of the Hopper kernels flash_fwd_sm90 and
                  flash_bwd_sm90; D=32 for the bf16 mma.sync kernels)
                  and at the flagship attention shape (dlse zero, as on
                  the model's path, and nonzero); tolerance
                  ||diff|| / ||ref|| <= TOL_REL for out/dq/dk/dv and
                  |diff| <= TOL_LSE for lse; then the same readings for a
                  planted fault (one dropped 64-wide tile: keys in the
                  forward, a Q tile in the backward), which must exceed
                  TOL_REL; and the fused backward's reproducibility (dk,
                  dv bitwise over two runs; dq, whose fp32 atomics add in
                  no fixed order, within TOL_REPRO), at the flagship
                  shape and, for the (64, 64) instance, at B2 S1023 H2;
4. kernels_fp32 — the same on fp32 inputs (the mma.sync kernels) at the
                  reference's streaming tier's shapes (its
                  TestStreamingKernels' B2 S384 H2 D16, causal x rope,
                  and B1 S8192 H2 D128, where its fp32 path streams), at
                  B1 S40 and S320 H2 D128 (causal x rope: ragged tiles,
                  a key half with no key left) and at the fp32 model's
                  (B1 S8191 H4 D128), within
                  TOL_REL_FP32 / TOL_LSE_FP32; at B1 S8192 H2 D128 a
                  planted fault (one dropped 64-wide tile) above
                  TOL_REL_FP32 and the reproducibility readings (the
                  forward's out and lse bitwise: its key halves meet in
                  a fixed order; dk, dv bitwise; dq within
                  TOL_REPRO_FP32);
5. kernels_long — bf16 at the long-context paths' shapes, B1 H16 D128
                  at S=8191 and 16383, and at S=16384, each kernel run
                  once at the full shape and its plain version two heads
                  at a time; a planted fault at 8192 of S=16383 and the
                  reproducibility reading at S=16384;
   kernels_mla  — bf16 at the Moonlight cell's attention (B6 S8191 H16,
                  causal, no rope in the kernels: latent attention ropes
                  its 64 dims before them, dlse nonzero) at (q.k, v) head
                  dims (192, 128) and, beside them, (128, 128), each
                  kernel run once at the full shape and its plain
                  version two heads at a time, within TOL_REL/TOL_LSE,
                  and each instance's reproducibility reading;
6. times        — the forward and the backward (one call of each
                  wrapper: one fused backward kernel on either route) at
                  the main path's shape (B8 S1023 H16 D128, causal,
                  rope): CUDA-event median, its roofline bound, its plain
                  version's time and PyTorch's SDPA forward and backward
                  as the yardstick; times_xl the same at B1 S16384 H16
                  D128 (plain versions at H2), times_fp32 at B1 S8192 H2
                  D128 fp32 against the 3xTF32 product path's peak;
                  times_mla_192x128 and times_mla_128x128 the same at
                  kernels_mla's shape (plain versions at H2, SDPA at the
                  full shape);
   moe_kernels  — the MoE FFN's kernels (csrc/moe_route.cu) at the MoE
                  LM cell's routing shapes (T 8192 tokens, 8 experts
                  drawn skewed so some overflow, capacity 1280, D 2048
                  bf16), each call as moe.py makes it, against its plain
                  version on the same card tensors: moe_route's five
                  outputs, moe_gather_rows' two uses (the dispatch and
                  the combine's backward) and moe_combine_rows' two at
                  k = 1 (the combine and the dispatch's backward) bit
                  for bit, moe_pair_dot at k = 1 (the gate's gradient)
                  within MOE_PAIR_DOT_TOL of its largest value;
                  CUDA-event time of each against its plain version's
                  and its compulsory bytes over the memory rate;
                  moe_topk_kernels the same for the top-k layer at the
                  Moonlight cell's routing (T 49146 tokens, each to 6
                  distinct of 64 experts, 8 held, D 2048 bf16):
                  moe_route_topk's outputs, moe_gather_rows' two uses and
                  moe_combine_rows' two (the combine and the dispatch's
                  backward) bit for bit, moe_pair_dot (the gates'
                  gradient) within MOE_PAIR_DOT_TOL;
   kimi_kda     — Kimi Delta Attention's chunk kernels (csrc/kda_chunk.cu)
                  at the Kimi Linear cell's shape (B1 S32767 H32, dk = dv
                  128) on two sets of decays, 1 to 16 times softplus a
                  head and the same times KDA_WEAK (state carried over
                  hundreds of the 512 chunks): the forward and the
                  backward once, o, dq, dk, dv, dg and dbeta against the
                  plain chunk form on the same tensors for the first and
                  the last head (norm of the difference over the plain's,
                  KDA_TOL), launches a call; CUDA-event medians of the
                  forward and the backward timed A B B A; the bound
                  (portbench/models/kimi_lm.py: kda_bounds); the plain
                  chunk form's time over all heads; and each kernel's
                  registers and stack from ptxas;
   kimi_mixer   — the KDA layer's fused prologue and epilogue
                  (csrc/mixer_prep.cu) at the cell's shape [1, 32767,
                  4096] bf16: short_conv (normed and not), short_conv_bwd,
                  gated_norm and gated_norm_bwd against their plain
                  versions on the same tensors (KDA_TOL), CUDA-event times
                  against the plain versions' and the bytes bound;
7. claim_path   — the device plane through the kubelet plugin: the
                  node's GPUs discovered through NVML (NativeBackend, the
                  host driver's libnvidia-ml.so.1; its count, names and
                  UUIDs held against torch's; inventory), the NVLink
                  clique read (clique) and the health event registration
                  per GPU (health_registration); whether grpc imports
                  (transports: {"grpc": true|false, "framed": true}; a
                  grpc_unavailable line names the failed import). A
                  GpuDriver over NativeBackend and a FakeCluster, sockets
                  and state under a scratch dir: its first ResourceSlice
                  publish (one device per NVML GPU with NVML's UUID and
                  name), then kubelet registration (GetInfo answers the
                  driver's name) and the self-probe (plugin). An
                  allocated claim for the GPU torch calls cuda:0,
                  prepared with NodePrepareResources over the framed
                  socket; the CDI specs its cdi_device_ids name (and
                  /dev/nvidia{minor}, /dev/nvidiactl) checked on disk;
                  the flagship train step at full width for CLAIM_STEPS
                  steps in a child process whose environment is the
                  claim's CDI env, as a container runtime applies it
                  (plan_from_env -> devices_from_env ->
                  launch_workload("train"), launch counts zeroed just
                  before): finite loss, the claim's UUID, n_layers x
                  steps launches of flash_fwd_sm90 and flash_bwd_sm90 and
                  none of the mma.sync kernels; NodeUnprepareResources
                  over the socket (spec and checkpoint entry gone); the
                  same cycle over gRPC where grpc imports; DeviceState's
                  own prepare/unprepare times, median, min and max over
                  CLAIM_TIMING_CYCLES cycles (claim_path); then
                  tpu_dra_torch.bench.bench_claim_to_ready on the card's
                  NativeBackend (claim_to_ready: p50/p10/p95 and the
                  breakdown) and one health-monitor wait that must end
                  with no event and no wedge (health);
   compute_domain — the compute-domain stack: the native domain daemon
                  READY by its own --check (cd_daemon); a two-node
                  ComputeDomain of simulated nodes (fake GPUs) through
                  the controller, two CD kubelet plugins and two real
                  daemons over a FakeCluster, cd_convergence_s from CD
                  creation to both channel claims prepared (host clock;
                  cd_convergence); then a one-node domain on this host: a
                  GpuDriver over NVML prepares a claim of the GPU torch
                  calls cuda:0 over its framed socket, the CD plugin (its
                  clique read through NVML) a channel claim on the same
                  node, and a claim child whose environment is the two
                  CDI envs merged plans with plan_from_env, starts its
                  node's NCCL group of the domain (world 1) at the env's
                  MASTER_ADDR:MASTER_PORT and runs the flagship train
                  step at full width for CLAIM_STEPS steps: finite
                  losses, the claim's UUID, rank 0 of 1 at that address,
                  n_layers x steps launches of flash_fwd_sm90 and
                  flash_bwd_sm90 and none of the mma.sync kernels; the
                  domain torn down with no node label, stamped DaemonSet
                  or template left (compute_domain);
   cluster      — the cluster tier: a SimCluster whose one node is this
                  host (its kubelet plugins read NVML), the driver
                  installed from manifests.all_manifests() (the chart's
                  default render: the webhook on a self-signed cert made
                  at render time where cryptography or openssl can make
                  one, and a claim with an unknown GpuConfig field then
                  denied at admission; else the render with
                  webhook.enabled=false and "webhook": "off: <why>"); the
                  plugin pod's
                  ResourceSlice with the card's UUID; the exclusive-GPU
                  demo (one pod, one claim from a template, `python -m
                  tpu_dra_torch.bench claim-child --steps CLAIM_STEPS`)
                  scheduled onto the node, its claim prepared by the
                  plugin subprocess over dra.sock (cluster_env: which of
                  yaml, grpc, cryptography, openssl the machine has):
                  Succeeded, the claim and the child on the card's UUID,
                  finite losses, n_layers x steps launches of
                  flash_fwd_sm90 and flash_bwd_sm90 and none of the
                  mma.sync kernels; after the pod's deletion no claim,
                  claim spec or checkpoint entry left; pod create ->
                  Running and -> Succeeded (host clock) and the child's
                  median step beside claim_path's, and the phase's own
                  seconds (cluster);
   e2e          — the e2e tier, `python -m tpu_dra_torch.e2e
                  --card-node` in a child process: a two-node SimCluster
                  whose n0 is this host (plugins on NVML) and n1 a
                  simulated node (MIG, MPS, health events and time
                  slices, which the card cannot show), the chart's
                  default render installed, then the ten suites (basics,
                  admission, gpu_claims, stress, multiprocess, health,
                  debug, cd_lifecycle, cd_failover, updowngrade), one
                  e2e_suite line each; every suite must pass and the
                  child exit 0. gpu_claims' first exclusive pod runs on
                  n0, on the card: `python -m tpu_dra_torch.bench
                  claim-child --steps CLAIM_STEPS` at the flagship's full
                  width, checked as cluster's pod (finite losses, n_layers
                  x steps launches of flash_fwd_sm90 and flash_bwd_sm90,
                  none of the mma.sync kernels); the suites' seconds and
                  the phase's (e2e);
   hot_restart  — tpu_dra_torch.bench.bench_hot_restart on NVML: client
                  threads on RetryingFramedClient prepare and unprepare
                  while the plugin restarts twice on its dirs: 0 failed
                  RPCs, 0 leaked claims, a reconnect per restart or more;
                  drain seconds, the RPCs' p50/p99 and the phase's
                  seconds (hot_restart);
   ops          — the ops benches on the host (tpu_dra_torch.bench
                  .ops_benches), one line each with its phase_s and the
                  host's cpu_count: the MIG and MPS claim-to-ready on a
                  fake inventory (ops_fake_inventory: no section failed,
                  both keys present), sustained prepare/unprepare for
                  OPS_SUSTAINED_S (ops_prepare_sustained: 0 RPC errors, 0
                  leaked claims, a pipeline in-flight peak of at most
                  OPS_INFLIGHT_MAX), scheduler churn (ops_sched_churn: 0
                  full relists, CEL compiles <= distinct expressions, no
                  leaked claim), topology (ops_topology: contiguity 1.0,
                  nothing unplaced), failover (ops_sched_failover: p50
                  <= OPS_FAILOVER_P50_GATE_MS) and the tracer's cost
                  (ops_trace_overhead); rates, p99s and the coalescing
                  ratio are read, not gated (the reference scales those
                  gates to the host's cores); then the phase's seconds
                  (ops); ops_sched_churn also reads the scheduler's pool
                  of SCHED_WORKERS workers (sched_workers);
   chaos        — the chaos tier on the host (tpu_dra_torch.simcluster
                  .chaos.walk_matrix) at CHAOS_SEEDS seeds x CHAOS_EVENTS
                  events (hack/chaos.sh runs the reference at 25 x 60),
                  the port's lock witness installed across the whole
                  matrix: every walk (plugin, scheduler at 4 workers,
                  topology, node death, leader kill) with zero
                  violations, the watch-flake scenario clean, and no
                  lock-order cycle; per walk its schedules, events,
                  injected counts per site, violations and the re-arm
                  sites that never fired (read, not checked); then
                  bench_chaos_recovery twice, on the fake node (the
                  reference's number) and on the card through NVML with
                  a claim of no sharing config: p50, p95 and crashes
                  each, and the phase's seconds (chaos); the witness
                  also covers one untimed NVML crash recovery after the
                  matrix, and its edges are exported to
                  build/analysis/chaos-edges.json;
   analysis     — the port's analysis tier on the host (host clock):
                  python -m tpu_dra_torch.analysis cold (no cache) over
                  tpu_dra_torch/, tests/test_torch_*.py and chip_smoke.py
                  with --require-justified: 0 findings, every
                  suppression justified, within hack/lint.sh's 180 s
                  cold-run limit; python -m tpu_dra_torch.analysis.drmc
                  at hack/drmc.sh's sizes (budget 200, >= 200 distinct
                  schedules, >= 30 crash points in each crash scenario,
                  then evict-churn, takeover-resync and shard-dispatch
                  at budget 250, each >= 200), exporting its witness's
                  edges; --check-witness over the chaos phase's edges
                  and over drmc's, 0 unexplained; the view-shadow walk
                  run_sched_schedule(11, 40) and --check-view-shadow, 0
                  unexplained drifts; MeshSliceHarness(2, 4)'s plan: 8
                  GPUs over 2 workers, contiguous, its modeled GB/s;
                  files, findings, suppressions, schedules per scenario,
                  crash points and the seconds of each (analysis);
   race         — the race tier on the host (tpu_dra_torch.race, host
                  clock): the domain daemon's ThreadSanitizer flavour
                  (built beside the daemon in build) driven by
                  race.tsan_drive, TSAN_OPTIONS halt_on_error=1
                  exitcode=66 in every process: two daemons listing each
                  other and a closed port, an idle client on each, rounds
                  of concurrent --check probes with SIGUSR1 reloads in
                  between, then SIGTERM: no report, both exit 0, READY
                  probes, a Q reply counting the live peer; drmc at
                  hack/race.sh's budget (600, --skip-crash) exporting its
                  edges; then, under the port's lock witness and view
                  shadow, the threaded paths of the CPU tier's witnessed
                  suites through the port's entry points (a two-node
                  ComputeDomain, scheduler failover behind electors, MPS
                  and MIG prepares on a fake inventory) and one hot
                  restart on NVML, each passing; no cycle, no drift; one
                  --check-witness/--check-view-shadow over the phase's
                  exports, 0 unexplained; daemon exit codes, probes,
                  peers seen, drives passed and failed, witness edges,
                  drifts and the seconds of each (race);
   scale        — bench_sched_scale10k at SCALE_NODES nodes x SCALE_PODS
                  pods with SCALE_WATCHERS hollow watchers, against a
                  SCALE_BASELINE same-process baseline: 0 full relists,
                  0 watcher overflows; the throughput ratio is read
                  beside hack/perf.sh's 0.5 gate (the reference scales
                  its rate gates to the host), with pods/s, the p50s
                  and the phase's seconds (scale);
8. main         — the flagship TransformerLM train step through
                  tpu_dra_torch.bench.bench_mfu, with the kernels' launch
                  counts zeroed just before and read just after: every
                  forward through flash_fwd_sm90 and every backward
                  through flash_bwd_sm90, n_layers x step calls of each;
9. long_ctx     — tpu_dra_torch.bench.bench_long_context at S=8192 and
                  at S=16384 (long_ctx_xl), each with the launch counts
                  zeroed just before and read just after, checked as in
                  main;
10. remat       — long_ctx_xl (S=16384) at remat "dots" and "full"
                  (bench_long_context(remat=...)), beside long_ctx_xl's
                  own "none" run: step time, peak memory, and the launch
                  counts, the forward (1 + recomputed) x n_layers x step
                  calls (each block's forward runs again in the
                  backward), the backward n_layers x step calls;
11. moe         — tpu_dra_torch.bench.bench_moe: the MoE LM at the
                  flagship's widths (MoEModelConfig's defaults: 8
                  experts, an MoE FFN every second block), step time,
                  tokens/s, peak memory, launch counts as in main, and
                  the MoE kernels' launches: per MoE block and step
                  call one moe_route, two moe_gather_rows, two
                  moe_combine_rows and one moe_pair_dot;
   dsv3         — a bf16 step of the DeepSeek-V3 family at Moonlight's
                  widths (one dense and two MoE blocks, 8 of 64 experts
                  held, top-6, B2 S2048) with the launch counts zeroed
                  just before two step calls and read just after: every
                  attention through the Hopper kernels' route (q.k 192,
                  v 128), none through the mma.sync one; per MoE block
                  and step call one moe_route_topk, two moe_gather_rows,
                  two moe_combine_rows and one moe_pair_dot, and no
                  moe_route;
   kimi         — a bf16 step of the Kimi Linear family at its published
                  widths and the cell's eight layers (B1 S4096, a 2048-id
                  vocabulary), launches zeroed just before its loss alone
                  and before one step call: per KDA layer 2 KDA launches
                  forward and 5 backward, 3 short convs and 1 gated norm
                  each way, one attention.kda range and its two counters;
                  per MLA layer one Hopper forward and backward; the
                  top-k MoE and loss-head kernels; the kernels line's KDA
                  and mixer rows take their launches from this step;
12. ring_local  — an N=4 ring emulated in one process at long_ctx_xl's
                  attention shape (B1 S16384 H16 D128 bf16, s_local 4096,
                  rope off) through the ring's own per-step partial and
                  merge, forward and backward (diagonal steps causal,
                  past steps non-causal, nonzero dlse from the merge),
                  held against one causal flash_attention_with_lse over
                  the whole S within TOL_REL, with its launch counts and
                  both times;
13. mesh_workloads — every registered workload through
                  meshbuild.launch_workload on the plan of a claim of the
                  node's GPUs, each starting a world-1 NCCL group: records
                  and launch counts, "train" the flagship as the DP x TP
                  step at a (1, 1) grid (n_layers x steps launches of
                  each Hopper kernel, none of the MoE kernels), "moe"
                  the expert-parallel FFN's forward (one moe_route,
                  one moe_gather_rows and one moe_combine_rows per
                  call); psum: bench_psum over the same
                  env (0.0 with its skip_reason on one GPU, the local
                  memory-bandwidth proxy against the card's 3.35 TB/s);
14. parity      — a reduced TransformerLM on the card, two seeds, the
                  kernel path against the same path on the kernels' plain
                  versions and against plain attention: logits and every
                  gradient leaf; parity_fp32 the kernel path of an fp32
                  model at S=8192 against its plain versions, each layer
                  launching flash_fwd twice and flash_bwd_mma once.

Then it prints the kernels' summary as one JSON line (one entry per TPU
kernel and route: rows 1-3 at the main path, rows 4-6, the streaming
tier, at S=16384, both through the Hopper kernels; then the mma.sync
route's rows 1-3, flash_fwd and flash_bwd_mma, with parity_fp32's
launches and times_fp32's times; each route's dq and dkv rows name its
one fused backward and its time; then one row per MoE layer ("layer":
"top1", "topk") and kernel, which replaces no TPU kernel, with its
times summed over one MoE block's launches of the kernel, the top-1
layer's with moe's launches and moe_kernels' times, the top-k layer's
with dsv3's launches and moe_topk_kernels' times; then the Hopper
kernels at the Moonlight cell's attention, flash_{fwd,bwd}_mla_192x128
with dsv3's launches and flash_{fwd,bwd}_mla_128x128, which no model
path here runs, with
kernels_mla's errors and times_mla's times), the nvidia-smi
name/power-limit line,
and last
{"ok": true,
"device": {...}}. Any failed check raises, so the script exits non-zero
without that last line; it refuses to run without a CUDA device.
`python3 chip_smoke.py claim-child [--steps N] [--warm N] [--wait-go]`
is the claim child (claim_path, compute_domain, shared_claim, mps, mig):
it reads its own environment as a claim's CDI env (in compute_domain,
merged with a channel claim's) and prints one JSON line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# Kernel vs plain version on the card. On an H100 (80GB HBM3, 700 W) the
# sound kernels read at most 2.1e-3 (out) and 4.4e-4 (dq/dk/dv, at
# S=16384); one dropped 64-wide tile reads 0.10 or more at S=1023 and
# 0.02 or more at S=16384.
TOL_REL = 5e-3   # out, dq, dk, dv: bf16 output rounding + summation order
TOL_LSE = 1e-4   # lse, absolute: fp32 sums in a different order
# dq of the fused backward over two runs, ||diff|| / ||dq||: its fp32
# atomics add the K tiles' partials in no fixed order, so a few values
# round to the neighbouring bf16 after the epilogue.
TOL_REPRO = 1e-3
# The same reading of the fp32 backward (flash_bwd_mma): its fp32 atomics
# add up to S/64 partials per dq element in no fixed order, and two
# orders differ by fp32 rounding, ~2^-24 * sqrt(S/64) relative (~1e-6 at
# S=8192); dq is not rounded further. 1e-5 leaves that room and stays
# below TOL_REL_FP32.
TOL_REPRO_FP32 = 1e-5
TOL_LOGITS = 1e-2   # model logits, relative norm (the reference's bound)
TOL_GRAD = 5e-2     # model gradient leaves, max-rel (the reference's bound)
# fp32 kernels against their fp32 plain versions: the reference's fp32
# kernel bound (tests/test_torch_flashattention.py:11-13); the 3xTF32
# products drop only a_lo.b_lo, ~2^-22 relative.
TOL_REL_FP32 = 2e-5   # out, dq, dk, dv
TOL_LSE_FP32 = 2e-5   # lse, absolute
TOL_LOGITS_FP32 = 1e-4   # fp32 model logits, relative norm
TOL_GRAD_FP32 = 1e-3     # fp32 model gradient leaves, max-rel
SMALL = dict(b=2, h=2, d=64)
FLAGSHIP_ATTN = dict(b=8, h=16, d=128)
MAIN_S = 1023   # the train path attends over max_seq - 1 positions
# The long-context paths: bench_long_context at S=8192 and 16384 runs
# the kernels at B1 H16 D128 over 8191 and 16383 positions; the times
# take S=16384. The kernels are checked at those full shapes; their dense
# plain versions run PLAIN_HEADS heads at a time, since at 16 heads the
# plain backward holds four [1, 16, S, S] fp32 tensors of 17 GB each.
LONG_S = 8192
XL_S = 16384
XL_ATTN = dict(b=1, h=16, d=128)
PLAIN_HEADS = 2
LONG_CHECK = dict(b=1, h=2, d=128)
FP32_LONG_S = 8192   # where the reference's fp32 path streams
FP32_MODEL_ATTN = dict(b=1, h=4, d=128)   # parity_fp32's attention
# The Moonlight cell's attention (portbench's moonlight.s8k_uniform: B6
# x S8191 input positions, 16 heads, no rope in the kernels: latent
# attention ropes its 64 dims before them), at its head dims (q.k 192,
# v 128) and, beside them, the flagship's (128, 128).
MLA_ATTN = dict(b=6, h=16)
MLA_S = 8191
MLA_HEAD_DIMS = ((192, 128), (128, 128))
# The MiMo-V2-Flash cell's attention calls (B1, S 32767 trained positions,
# 64 query heads at (192, 128)): a global layer's over 4 K/V heads (dlse
# zero: its lse has no consumer), a window layer's over 8 with a 128-key
# window (dlse nonzero: the sink rescale reads its lse).
MIMO_S = 32767
MIMO_HEADS = 64
MIMO_CALLS = {"global": dict(hkv=4, window=0),
              "window": dict(hkv=8, window=128)}
# The Kimi Linear cell's KDA calls (B1, S 32767 trained positions, 32
# heads of dk = dv = 128) and the limit on each of o, dq, dk, dv, dg and
# dbeta against the plain chunk form: ||diff|| / ||plain||, the Hopper
# rows' limit.
KIMI_S = 32767
KIMI_HEADS = 32
KDA_TOL = 5e-3
# The kimi_kda phase's second set of decays: the same per-head scales
# times KDA_WEAK, so the mildest head decays by ~0.05 nats a chunk and
# its state carries over some hundred of the 512 chunks.
KDA_WEAK = 1e-3
# What one KDA call launches: its forward the intra-chunk pass and the
# state pass; its backward those again (the chunks' states recomputed),
# then the state's backward pass, the states' gradients and the
# intra-chunk backward.
KDA_CALL_LAUNCHES = {
    "kda_fwd": {"kda_intra": 1, "kda_state_fwd": 1},
    "kda_bwd": {"kda_intra": 1, "kda_state_fwd": 1, "kda_state_bwd": 1,
                "kda_dstate": 1, "kda_intra_bwd": 1}}
# The KDA layer's prologue and epilogue kernels (csrc/mixer_prep.cu):
# each call's compulsory bytes per element of its [B, T, C] bf16
# activations (the conv reads x, writes out; its backward reads x and
# dout, writes dx; the gated norm reads o and gate, writes out; its
# backward reads o, gate and dout, writes do and dgate), and what one
# KDA layer launches of each (short convs of q, k and v, one gated
# norm).
MIXER_BYTES = {"short_conv_fwd": 4, "short_conv_bwd": 6,
               "gated_norm_fwd": 6, "gated_norm_bwd": 10}
MIXER_LAYER_LAUNCHES = {"short_conv_fwd": 3, "short_conv_bwd": 3,
                        "gated_norm_fwd": 1, "gated_norm_bwd": 1}
H100_SXM = "NVIDIA H100 80GB HBM3"
SOURCES = {
    "flash_fwd_sm90": "tpu_dra_torch/workloads/csrc/flash_fwd_sm90.cu",
    "flash_fwd": "tpu_dra_torch/workloads/csrc/flash_fwd.cu",
    "flash_bwd_sm90": "tpu_dra_torch/workloads/csrc/flash_bwd_sm90.cu",
    "flash_bwd_mma": "tpu_dra_torch/workloads/csrc/flash_bwd_mma.cu",
    "moe_route": "tpu_dra_torch/workloads/csrc/moe_route.cu",
    "loss_head": "tpu_dra_torch/workloads/csrc/loss_head.cu",
    "kda_chunk": "tpu_dra_torch/workloads/csrc/kda_chunk.cu",
    "mixer_prep": "tpu_dra_torch/workloads/csrc/mixer_prep.cu",
}
# Every TPU kernel in the repo, per route: (entry name, timed wrapper,
# port kernel, replaces). Rows 4-6, the streaming tier, are the same
# kernels held at the tier's shapes (tpu_dra_torch/workloads/
# flashattention.py says why). The forward wrapper routes bf16 at D 64
# and 128 (every model path) to flash_fwd_sm90, fp32 to flash_fwd; the
# backward wrapper routes the same inputs to flash_bwd_sm90 and
# flash_bwd_mma, each one fused pass that stands for the dq and the dkv
# kernel. The "_fp32" rows are the mma.sync route.
TPU_KERNELS = [
    ("flash_fwd", "flash_fwd", "flash_fwd_sm90",
     "tpu_dra/workloads/flashattention.py:191"),
    ("flash_bwd_dq", "flash_bwd", "flash_bwd_sm90",
     "tpu_dra/workloads/flashattention.py:269"),
    ("flash_bwd_dkv", "flash_bwd", "flash_bwd_sm90",
     "tpu_dra/workloads/flashattention.py:339"),
    ("flash_fwd_xl", "flash_fwd", "flash_fwd_sm90",
     "tpu_dra/workloads/flashattention.py:491"),
    ("flash_bwd_dq_xl", "flash_bwd", "flash_bwd_sm90",
     "tpu_dra/workloads/flashattention.py:550"),
    ("flash_bwd_dkv_xl", "flash_bwd", "flash_bwd_sm90",
     "tpu_dra/workloads/flashattention.py:601"),
    ("flash_fwd_fp32", "flash_fwd", "flash_fwd",
     "tpu_dra/workloads/flashattention.py:191"),
    ("flash_bwd_dq_fp32", "flash_bwd", "flash_bwd_mma",
     "tpu_dra/workloads/flashattention.py:269"),
    ("flash_bwd_dkv_fp32", "flash_bwd", "flash_bwd_mma",
     "tpu_dra/workloads/flashattention.py:339"),
]
# The MoE LM cell's routing (portbench's moe_lm.s1k_uniform: B8 x S1024
# tokens, 8 experts, capacity factor 1.25, d_model 2048, bf16), where
# moe_kernels holds the MoE FFN's kernels against their plain versions.
MOE_TOKENS, MOE_EXPERTS, MOE_D, MOE_CAPACITY_FACTOR = 8 * 1024, 8, 2048, 1.25
# moe_pair_dot sums D fp32 products in another order than torch.sum.
MOE_PAIR_DOT_TOL = 1e-5
MOE_REPLACES = ("replaces no TPU kernel (the reference's dense one-hot "
                "dispatch and combine einsums, tpu_dra/workloads/moe.py)")
TOPK_REPLACES = ("replaces no TPU kernel (the JAX package has no top-k "
                 "layer)")
# Launches per MoE block and step call of each routing's layer: its
# route; the dispatch (a gather) and its backward (a k-way sum, k = 1 at
# top-1); the combine (a k-way sum) and its backward (a gather and the
# gates' pair dot).
_MOE_ROW_LAUNCHES = {"moe_gather_rows": 2, "moe_combine_rows": 2,
                     "moe_pair_dot": 1}
MOE_BLOCK_LAUNCHES = {
    "top1": {"moe_route": 1, "moe_route_topk": 0, **_MOE_ROW_LAUNCHES},
    "topk": {"moe_route": 0, "moe_route_topk": 1, **_MOE_ROW_LAUNCHES},
}
# The Moonlight cell's routing (B6 x S8191 tokens, each to 6 of 64
# experts, experts [0, 8) held, d_model 2048, bf16), where moe_kernels
# holds the top-k layer's kernels against their plain versions.
TOPK_TOKENS, TOPK_K, TOPK_EXPERTS, TOPK_HELD = 6 * 8191, 6, 64, 8
# The kernel each call of phase_moe_kernels launches, either layer's.
MOE_CALL_KERNELS = {"dispatch_fwd": "moe_gather_rows",
                    "combine_bwd": "moe_gather_rows",
                    "combine_fwd": "moe_combine_rows",
                    "dispatch_bwd": "moe_combine_rows",
                    "gate_grad": "moe_pair_dot"}
# The loss head's rows N = B x (S - 1) and vocabulary V in each cell: both
# S=1024 cells (B8), flagship.s16k_uniform (B1 x S16384) and
# moonlight.s8k_uniform (B6 x S8192 over its 20480-id slice).
LOSS_SHAPES = {"s1k": (8 * 1023, 32768), "s16k": (16383, 32768),
               "moonlight": (6 * 8191, 20480)}
# lse within LOSS_TOL relative; nll within LOSS_TOL of max(|nll|, |lse|)
# (it is lse less one logit); dlogits within one bf16 ulp.
LOSS_TOL = 2e-6
LOSS_REPLACES = ("replaces no TPU kernel (the reference computes the loss "
                 "in XLA, tpu_dra/workloads/model.py: token_nll)")


# The dsv3 phase's train step: the DeepSeek-V3 family at Moonlight's
# widths, cut to one dense and two MoE blocks, B2 x S2048 and a 2048-id
# vocabulary.
DSV3_STEP = dict(vocab=2048, d_model=2048, n_heads=16, n_layers=3,
                 d_ff=11264, max_seq=2048, qk_nope_dim=128, qk_rope_dim=64,
                 v_head_dim=128, kv_rank=512, moe_d_ff=1408, n_routed=64,
                 experts_held=(0, TOPK_HELD), top_k=TOPK_K, n_shared=2)
DSV3_BATCH, DSV3_STEPS = 2, 2
# The mimo phase's train step: the MiMo-V2-Flash family at its published
# widths and the cell's seven layers (global dense, window x 4, global,
# window; 8 of 256 experts held, top-8), B1 x S4096 and a 2048-id
# vocabulary.
MIMO_STEP = dict(vocab=2048, d_model=4096, n_heads=MIMO_HEADS, n_layers=7,
                 d_ff=16384, max_seq=4096, n_kv_heads=4, swa_kv_heads=8,
                 qk_head_dim=192, v_head_dim=128, rope_dims=64,
                 window=128, hybrid_pattern=(0, 1, 1, 1, 1, 0, 1),
                 sink_offset=math.log(128), first_dense=1, moe_d_ff=2048,
                 n_routed=256, experts_held=(0, 8), top_k=8)
# The kimi phase's train step: the Kimi Linear cell's configuration file
# (its published widths and eight layers: KDA x 3 and MLA, twice; 8 of
# 256 experts held, top-8), B1 x S4096 and a 2048-id vocabulary.
KIMI_CONFIG = os.path.join("portbench", "configs", "kimi_linear.json")
KIMI_STEP = dict(vocab_size=2048, vocab=2048)
KIMI_STEP_S = 4096
# What a bf16 model path at D=128 launches per forward/backward: the
# Hopper kernels, never the mma.sync ones.
MODEL_PATH_KERNELS = ("flash_fwd_sm90", "flash_bwd_sm90")
# Train steps of the claim_path child (full width; depth and batch as the
# main path's).
CLAIM_STEPS = 3
CLAIM_TIMING_CYCLES = 50
# cluster: how long the demo pod may stay Pending (scheduling, prepare).
POD_START_TIMEOUT_S = 180
# e2e: the ten suites in order, and the child's time limit.
E2E_SUITES = ("basics", "admission", "gpu_claims", "stress", "multiprocess",
              "health", "debug", "cd_lifecycle", "cd_failover",
              "updowngrade")
E2E_TIMEOUT_S = 600
E2E_LOG = os.path.join(ROOT, "build", "e2e", "stderr.log")
# hot_restart: client threads, seconds of load and plugin restarts.
HOT_RESTART_WORKERS = 4
HOT_RESTART_S = 6.0
HOT_RESTARTS = 2
# Timed steps of mesh_workloads' "train" (after one warm step).
# The ops phase: hack/perf.sh's own sustained duration and invariants.
OPS_SUSTAINED_S = 25.0
OPS_INFLIGHT_MAX = 16             # the pipeline's admission window
SCHED_WORKERS = 4                 # the scheduler pool's default size
# The chaos matrix and the scale-out bench, cut to fit the script's time
# (the reference's hack/chaos.sh runs 25 seeds x 60 events; its
# bench_sched_scale10k defaults to 10000 nodes x 100000 pods, 100
# watchers, a 1000 x 5000 baseline).
CHAOS_SEEDS = 5
CHAOS_EVENTS = 40
CHAOS_RECOVERY_CRASHES = 7
SCALE_NODES = 1000
SCALE_PODS = 10000
SCALE_WATCHERS = 20
SCALE_BASELINE = (100, 1000)      # nodes, pods
SCALE_RATIO_GATE = 0.5            # hack/perf.sh's PERF_SCALE10K_RATIO
OPS_FAILOVER_P50_GATE_MS = 2000.0
MESH_TRAIN_STEPS = 3
# The analysis phase: the port's dralint and drmc at hack/lint.sh's and
# hack/drmc.sh's sizes, with their exports under build/ (gitignored).
ANALYSIS_DIR = os.path.join(ROOT, "build", "analysis")
CHAOS_EDGES = os.path.join(ANALYSIS_DIR, "chaos-edges.json")
DRMC_EDGES = os.path.join(ANALYSIS_DIR, "drmc-edges.json")
VIEW_DRIFTS = os.path.join(ANALYSIS_DIR, "view-drifts.json")
LINT_COLD_LIMIT_S = 180    # hack/lint.sh's cold-run wall-clock gate
DRMC_GATE = ["--budget", "200", "--min-schedules", "200",
             "--min-crash-points", "30", "--deadline", "180"]
DRMC_FLOORS = ("evict-churn", "takeover-resync", "shard-dispatch")
DRMC_FLOOR_ARGS = ["--budget", "250", "--min-schedules", "200",
                   "--deadline", "120", "--skip-crash"]
DRMC_MIN_SCHEDULES = 200
DRMC_MIN_CRASH_POINTS = 30
VIEW_SHADOW_WALK = (11, 40)   # run_sched_schedule(seed, events)
# The race phase: the TSan drive at the race tier's own sizes, deep drmc
# at hack/race.sh's budget, and its exports under build/race/.
RACE_DIR = os.path.join(ROOT, "build", "race")
RACE_EDGES = os.path.join(RACE_DIR, "card-edges.json")
RACE_DRIFTS = os.path.join(RACE_DIR, "card-drifts.json")
RACE_DRMC_BUDGET = 600
RACE_FAILOVERS = 2
# Ranks of the ring emulated by ring_local.
RING_N = 4
CLAIM_CHILD = "claim-child"
NODE = "node-0"   # the node name the claim_path plugin publishes for


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase_probe() -> dict:
    import torch

    from tpu_dra_torch.native import gpuinfo

    info = gpuinfo.probe()
    check(info["count"] >= 1, "no CUDA device counted")
    check(tuple(info["capability"]) == (9, 0),
          f"kernels are built for sm_90a; card is sm_{info['capability']}")
    nvcc = info["nvcc"]
    check(nvcc is not None, "nvcc not found")
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    info["nvcc_version"] = version.splitlines()[-1] if version else ""
    info["torch"] = torch.__version__
    info["torch_cuda"] = torch.version.cuda
    emit("probe", **info)
    return info


def phase_build() -> None:
    """The kernels (one nvcc per source, started together) and, beside
    them on a thread, the native domain daemon and its ThreadSanitizer
    flavour (c++)."""
    import threading

    from tpu_dra_torch.cddaemon import binary
    from tpu_dra_torch.workloads import _cuda

    daemon = {}

    def build_daemon():
        t = time.perf_counter()
        try:
            daemon["path"] = binary.build()
            daemon["tsan"] = binary.build(tsan=True)
        except Exception as e:  # noqa: BLE001 — re-raised below
            daemon["error"] = e
        daemon["seconds"] = time.perf_counter() - t

    t0 = time.perf_counter()
    thread = threading.Thread(target=build_daemon)
    thread.start()
    libs = _cuda.build()
    thread.join()
    seconds = time.perf_counter() - t0
    if "error" in daemon:
        raise daemon["error"]
    emit("build", seconds=seconds, libs=[str(p) for p in libs.values()],
         daemon=os.path.relpath(daemon["path"], ROOT),
         daemon_tsan=os.path.relpath(daemon["tsan"], ROOT),
         daemon_build_s=daemon["seconds"])


def _inputs(b, s, h, d, seed, dtype=None, zero_dlse=False, dv=None):
    import torch

    dtype = dtype or torch.bfloat16
    dv = dv or d
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, to=dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(to)

    # q, k, v as views of one fused projection, as the model passes them
    # (q and k of head dim d, v of dv).
    qkv = randn(b, s, h * (2 * d + dv))
    q, k, v = (t.view(b, s, h, -1)
               for t in qkv.split([h * d, h * d, h * dv], dim=-1))
    dout = randn(b, s, h, dv)
    dlse = randn(b, h, s, to=torch.float32) * (0.0 if zero_dlse else 0.1)
    return q, k, v, dout, dlse


def _tables(s, d, rope, dtype=None):
    import torch

    from tpu_dra_torch.workloads.flashattention import _rope_operands

    return (_rope_operands(s, d, dtype or torch.bfloat16,
                           torch.device("cuda")) if rope else None)


def _free() -> None:
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _max_rel(got, ref) -> float:
    scale = max(float(ref.float().abs().max()), 1e-6)
    return float((got.float() - ref.float()).abs().max()) / scale


class Diff:
    """got against ref for one output, summed over head chunks, so that
    the readings are those of the whole tensors: ||got - ref|| / ||ref||
    (`rel`: every row weighs by its own size, so an error confined to the
    far rows of a causal output, whose values are small beside row 0's,
    still shows), max |got - ref| (`abs`) and max |got - ref| / max |ref|
    (`max_rel`)."""

    def __init__(self):
        self.diff_sq = self.ref_sq = self.diff_max = self.ref_max = 0.0

    def add(self, got, ref) -> None:
        ref = ref.float()
        diff = got.float() - ref
        self.diff_sq += float(diff.square().sum())
        self.ref_sq += float(ref.square().sum())
        self.diff_max = max(self.diff_max, float(diff.abs().max()))
        self.ref_max = max(self.ref_max, float(ref.abs().max()))

    @property
    def rel(self) -> float:
        return math.sqrt(self.diff_sq) / max(math.sqrt(self.ref_sq), 1e-12)

    @property
    def abs(self) -> float:
        return self.diff_max

    @property
    def max_rel(self) -> float:
        return self.diff_max / max(self.ref_max, 1e-6)


def _heads(args, hs):
    """The operands (q, k, v, dout, lse, delta, dlse, tables) of heads
    `hs`: [B, S, H, D] tensors sliced on dim 2, [B, H, S] ones on dim 1."""
    q, k, v, dout, lse, delta, dlse, tables = args
    return (*(x[:, :, hs] for x in (q, k, v, dout)),
            *(x[:, hs] for x in (lse, delta, dlse)), tables)


def check_case(s, causal, rope, b, h, d, seed, dtype=None, chunk=None,
               fault_at=None, zero_dlse=False, repro=False,
               fwd_repro=False, dv=None) -> dict:
    """The forward and the backward wrapper once on one set of [b, s, h,
    d] inputs (v and dout of head dim `dv`, d by default; bf16 unless
    `dtype` says otherwise; q, k, v views of one fused projection, as
    the model passes them), against their plain
    versions on the same tensors, `chunk` heads at a time (all at once by
    default: the dense plain backward at long S holds four [B, chunk, S,
    S] fp32 tensors), at the tolerances of that type. With `fault_at`,
    also the planted-fault readings at these inputs (planted_faults);
    with `repro`, the backward's reproducibility (check_repro); with
    `fwd_repro`, the forward's (check_fwd_repro)."""
    import torch

    from tpu_dra_torch.workloads import _flash_kernels as fk

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    tol_rel = TOL_REL_FP32 if fp32 else TOL_REL
    tol_lse = TOL_LSE_FP32 if fp32 else TOL_LSE
    chunk = chunk or h
    q, k, v, dout, dlse = _inputs(b, s, h, d, seed, dtype, zero_dlse, dv)
    d_v = v.shape[-1]
    tables = _tables(s, d, rope, dtype)
    o, lse = fk.fwd(q, k, v, tables, causal=causal)
    # The backward takes the kernel's (o, lse) on both sides.
    delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, dout, lse, delta, dlse, tables)
    dq, dk, dv = fk.bwd(*args, causal=causal)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(x.float()).all())
                 for x in (o, lse, dq, dk, dv))
    names = ("out", "lse", "dq", "dk", "dv")
    diffs = {name: Diff() for name in names}
    faults = {name: Diff() for name in names if name != "lse"}
    for h0 in range(0, h, chunk):
        hs = slice(h0, h0 + chunk)
        sub = _heads(args, hs)
        o_ref, lse_ref = fk.fwd_plain(*sub[:3], tables, causal=causal)
        refs = {"out": o_ref, "lse": lse_ref}
        refs["dq"], refs["dk"], refs["dv"] = fk.bwd_plain(*sub,
                                                          causal=causal)
        for name, got in zip(names, (o[:, :, hs], lse[:, hs], dq[:, :, hs],
                                     dk[:, :, hs], dv[:, :, hs])):
            diffs[name].add(got, refs[name])
        if fault_at is not None:
            for name, fault in planted_faults(sub, fault_at).items():
                faults[name].add(fault, refs[name])
        del sub, refs, o_ref, lse_ref
    res = {
        "s": s, "causal": causal, "rope": rope, "b": b, "h": h, "d": d,
        "dv": d_v, "dtype": str(dtype).removeprefix("torch."),
        "fwd_kernel": fk.FWD_KERNELS[fk.route(dtype, d, d_v)],
        "bwd_kernels": fk.BWD_KERNELS[fk.route(dtype, d, d_v)],
        "dlse": "zero" if zero_dlse else "nonzero", "finite": finite,
        "plain_heads_per_pass": chunk, "lse_abs": diffs["lse"].abs,
        **{f"{n}_rel": diffs[n].rel for n in names if n != "lse"},
        **{f"{n}_abs": diffs[n].abs for n in names if n != "lse"},
    }
    emit("kernels", **res)
    check(finite, f"non-finite kernel output at {res}")
    for key in ("out_rel", "dq_rel", "dk_rel", "dv_rel"):
        check(res[key] <= tol_rel, f"{key} {res[key]} > {tol_rel} at {res}")
    check(res["lse_abs"] <= tol_lse,
          f"lse_abs {res['lse_abs']} > {tol_lse} at {res}")
    if fault_at is not None:
        fres = {**{f"{n}_rel": f.rel for n, f in faults.items()},
                **{f"{n}_max_rel": f.max_rel for n, f in faults.items()}}
        emit("planted_faults", s=s, b=b, h=h, d=d, tile_start=fault_at,
             dtype=res["dtype"], tol_rel=tol_rel, **fres)
        for name in faults:
            check(fres[f"{name}_rel"] > tol_rel,
                  f"a dropped tile reads {fres[name + '_rel']} on {name}, "
                  f"within {tol_rel}: the check cannot see it")
    if repro:
        res.update(check_repro(args, causal, (dq, dk, dv),
                               TOL_REPRO_FP32 if fp32 else TOL_REPRO))
    if fwd_repro:
        res.update(check_fwd_repro(args, causal, (o, lse)))
    return res


def check_fwd_repro(args, causal, first) -> dict:
    """The forward wrapper run again on the same operands: out and lse
    must equal the first run's bit for bit (each row's partials meet in
    a fixed order)."""
    import torch

    from tpu_dra_torch.workloads import _flash_kernels as fk

    q, k, v = args[:3]
    o, lse = fk.fwd(q, k, v, args[-1], causal=causal)
    torch.cuda.synchronize()
    res = {"repro_out_equal": bool(torch.equal(o, first[0])),
           "repro_lse_equal": bool(torch.equal(lse, first[1]))}
    emit("fwd_repro", s=q.shape[1], dtype=str(q.dtype),
         fwd_kernel=fk.FWD_KERNELS[fk.route(q.dtype, q.shape[-1],
                                            args[2].shape[-1])],
         **res)
    check(res["repro_out_equal"] and res["repro_lse_equal"],
          f"the forward's out/lse differ between two runs: {res}")
    return res


def check_repro(args, causal, first, tol) -> dict:
    """The backward wrapper run again on the same operands: dk and dv
    must equal the first run's bit for bit (each is summed by one CTA in
    a fixed order); dq's ||diff|| / ||dq|| is read and held within `tol`
    (its K tiles' partials meet in fp32 atomics)."""
    import torch

    from tpu_dra_torch.workloads import _flash_kernels as fk

    dq, dk, dv = fk.bwd(*args, causal=causal)
    torch.cuda.synchronize()
    dq0, dk0, dv0 = first
    res = {"repro_dk_equal": bool(torch.equal(dk, dk0)),
           "repro_dv_equal": bool(torch.equal(dv, dv0)),
           "repro_dq_rel": float((dq.float() - dq0.float()).norm()
                                 / dq0.float().norm()),
           "repro_dq_values_changed": int((dq != dq0).sum())}
    emit("repro", s=args[0].shape[1], dtype=str(args[0].dtype),
         bwd_kernel=fk.BWD_KERNELS[fk.route(args[0].dtype,
                                            args[0].shape[-1],
                                            args[2].shape[-1])],
         tol=tol, **res)
    check(res["repro_dk_equal"] and res["repro_dv_equal"],
          f"dk/dv differ between two runs: {res}")
    check(res["repro_dq_rel"] <= tol,
          f"dq run-to-run {res['repro_dq_rel']} > {tol}")
    return res


def phase_kernels() -> dict:
    """Small cases at D=64 and 128 (S=40, 320 and 384, causal and not,
    rope and not; S=1023 causal: every branch of flash_fwd_sm90 and
    flash_bwd_sm90, ragged Q and K tiles included; the (64, 64) instance's
    reproducibility reading at S=1023 with rope) and D=32 (bf16 through
    the mma.sync kernels), then the flagship attention shape with dlse
    zero (the model's path) and with a planted fault and the
    reproducibility reading. Returns the flagship shape's readings."""
    cases = [(s, c, r) for s in (384, 320, 40) for c in (True, False)
             for r in (True, False)]
    cases += [(1023, True, True), (1023, True, False)]
    for i, (s, causal, rope) in enumerate(cases):
        check_case(s, causal, rope, seed=i,
                   repro=(s, causal, rope) == (1023, True, True), **SMALL)
        check_case(s, causal, rope, seed=200 + i,
                   **{**SMALL, "d": FLAGSHIP_ATTN["d"]})
    for i, (causal, rope) in enumerate(((True, True), (False, False))):
        check_case(384, causal, rope, seed=220 + i, **{**SMALL, "d": 32})
    check_case(1024, True, True, seed=100, zero_dlse=True, **FLAGSHIP_ATTN)
    return check_case(MAIN_S, True, True, seed=101, fault_at=512,
                      repro=True, **FLAGSHIP_ATTN)


def phase_kernels_fp32() -> dict:
    """fp32 inputs at the reference's streaming-tier shapes: its
    TestStreamingKernels' (B2 S384 H2 D16, causal x rope, beside B1 S40
    and S320 H2 D128) and B1 S8192 H2 D128, where its fp32 path streams,
    the latter with a planted fault at its middle tile and both
    wrappers' reproducibility readings; then the fp32 model's own shape
    (parity_fp32: B1 S8191 H4 D128). Returns the B1 S8192 H2 D128
    readings (times_fp32's shape)."""
    import torch

    for i, (causal, rope) in enumerate((c, r) for c in (True, False)
                                       for r in (True, False)):
        check_case(384, causal, rope, b=2, h=2, d=16, seed=300 + i,
                   dtype=torch.float32)
        for j, s in enumerate((40, 320)):
            check_case(s, causal, rope, b=1, h=2, d=128,
                       seed=320 + 4 * j + i, dtype=torch.float32)
    res = check_case(FP32_LONG_S, True, True, seed=310, dtype=torch.float32,
                     fault_at=FP32_LONG_S // 2, repro=True, fwd_repro=True,
                     **LONG_CHECK)
    _free()
    check_case(FP32_LONG_S - 1, True, True, seed=311, dtype=torch.float32,
               chunk=PLAIN_HEADS, **FP32_MODEL_ATTN)
    _free()
    return res


def phase_kernels_long() -> dict:
    """bf16 at every shape the long-context paths give the kernels (B1
    H16 D128 at S=8191 and 16383) and at the S=16384 the times take, the
    plain versions PLAIN_HEADS heads at a time, with a planted fault at
    the middle tile of the long_ctx_xl shape and the reproducibility
    reading at S=16384. Returns the long_ctx_xl shape's readings."""
    check_case(LONG_S - 1, True, True, seed=400, chunk=PLAIN_HEADS,
               **XL_ATTN)
    _free()
    check_case(XL_S, True, True, seed=401, chunk=PLAIN_HEADS, repro=True,
               **XL_ATTN)
    _free()
    res = check_case(XL_S - 1, True, True, seed=402, chunk=PLAIN_HEADS,
                     fault_at=XL_S // 2, **XL_ATTN)
    _free()
    return res


def planted_faults(args, tile_start) -> dict:
    """What the kernel checks would read for a kernel that drops one
    64-wide tile: the plain versions' outputs on `args` (q, k, v, dout,
    lse, delta, dlse, tables; causal, rope) with keys [tile_start, +64)
    cut from the forward's softmax, and the Q tile [tile_start, +64) cut
    from the backward's stream (its dq rows get nothing, dk and dv lose
    its terms). check_case holds these against the plain versions' own
    outputs: each reading must clear TOL_REL, or the check could not see
    such a fault."""
    import torch

    from tpu_dra_torch.workloads import _flash_kernels as fk

    q, k, v, dout = args[:4]
    tables = args[-1]
    t = slice(tile_start, tile_start + fk.BLOCK)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def in_dot(spec, a, x):   # a rounded to the input type, as the kernels
        return torch.einsum(spec, a.to(q.dtype).float(), x.float())

    def unrope(x):
        return fk.rope_rotate(x, *tables, inverse=True).to(q.dtype)

    scores, qr, kr = fk._scores(q, k, tables, True)
    scores[..., t] = fk.NEG_INF
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    del scores
    out = {"out": (in_dot("bhqk,bkhd->bqhd", p, v)
                   / p.sum(-1).permute(0, 2, 1)[..., None]).to(q.dtype)}
    del p
    p, ds, _, _ = fk._probs_and_ds(*args, causal=True)
    p[..., t, :] = 0
    ds[..., t, :] = 0
    out["dq"] = unrope(in_dot("bhqk,bkhd->bqhd", ds, kr) * scale)
    out["dv"] = in_dot("bhqk,bqhd->bkhd", p, dout).to(q.dtype)
    out["dk"] = unrope(in_dot("bhqk,bqhd->bkhd", ds, qr) * scale)
    return out


def time_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median over `reps` CUDA-event windows of `inner` back-to-back calls,
    per call, after a warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bounds(b, s, h, d, peak_flops, peak_bytes, elem=2, dv=None,
           rope=True, hkv=None, window=0) -> dict:
    """Least time for each kernel's work at this shape (q and k of head
    dim d, v of dv, d by default; k and v at `hkv` heads, h by default;
    the rope tables read where `rope`): the larger of its tensor-core
    FLOPs (the causal pairs only, or with a `window` the band's, B H sum
    of min(i + 1, W)) over `peak_flops` and its compulsory bytes (each
    input read once, each output written once, in elements of `elem`
    bytes) over the memory rate."""
    from tpu_dra_torch.workloads import _flash_kernels as fk

    dv, hkv = dv or d, hkv or h
    pairs = b * h * fk.band_pairs(s, window or s)
    q = b * s * h * d * elem          # q (or dq): [B, S, H, D]
    k = b * s * hkv * d * elem        # k (or dk): [B, S, Hkv, D]
    v = b * s * hkv * dv * elem       # v (or dv): [B, S, Hkv, Dv]
    o = b * s * h * dv * elem         # o (or dO): [B, S, H, Dv]
    row = b * h * s * 4               # one fp32 [B, H, S] row vector
    tables = 2 * s * d * elem if rope else 0   # cos and sinm
    work = {
        # q, k, v in; o, lse out. QK^T and PV.
        "flash_fwd": (2 * (d + dv) * pairs, q + k + v + o + row + tables),
        # The fused backward: q, k, v, dO, lse, delta, dlse in; dq, dk, dv
        # out. QK^T, dO V^T, P^T dO, dS^T Q, dS K (its fp32 dQ
        # accumulator is scratch).
        "flash_bwd": (2 * (3 * d + 2 * dv) * pairs,
                      2 * q + 2 * k + 2 * v + o + 3 * row + tables),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
        out[name] = {
            "flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
    return out


def time_kernels(label, b, s, h, d, peak_flops, peak_bytes, dtype=None,
                 plain_h=None, inner=10, dv=None, rope=True) -> dict:
    """The forward and the backward wrapper at [b, s, h, d] (v of head
    dim `dv`, d by default; causal, rope unless `rope` is False, out-only
    dlse as on the model's path): CUDA-event time, bound, plain version's
    time (at `plain_h` heads where the dense plain version would not fit
    at h) and PyTorch's SDPA forward and backward at [b, s, h] as the
    yardstick (None where SDPA refuses the head dims)."""
    import torch
    import torch.nn.functional as F

    from tpu_dra_torch.workloads import _flash_kernels as fk

    dtype = dtype or torch.bfloat16
    plain_h = plain_h or h
    q, k, v, dout, dlse = _inputs(b, s, h, d, seed=7, dtype=dtype, dv=dv)
    dlse.zero_()   # the model's path: out-only consumer
    tables = _tables(s, d, rope, dtype)

    def operands(q, k, v, dout, dlse):
        o, lse = fk.fwd(q, k, v, tables, causal=True)
        delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
        return (q, k, v, dout, lse, delta.contiguous(), dlse, tables)

    args = operands(q, k, v, dout, dlse)
    ms = {
        "flash_fwd": time_ms(lambda: fk.fwd(q, k, v, tables, causal=True),
                             inner=inner),
        "flash_bwd": time_ms(lambda: fk.bwd(*args, causal=True),
                             inner=inner),
    }
    # Yardstick only (the port never calls it): SDPA on the roped inputs,
    # [B, H, S, D] contiguous, forward and backward (dq, dk, dv together).
    qr, kr = ((x if tables is None else fk.rope_rotate(x, *tables))
              .transpose(1, 2).contiguous() for x in (q, k))
    vr = v.transpose(1, 2).contiguous()
    try:
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True), inner=inner)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qr, kr, vr))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        do_t = dout.transpose(1, 2).contiguous()
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do_t, retain_graph=True), inner=inner)
        del qg, kg, vg, out, do_t
    except RuntimeError:   # no SDPA backend for these head dims
        sdpa_fwd = sdpa_bwd = None
    del qr, kr, vr
    if plain_h != h:
        del args, q, k, v, dout, dlse
        _free()
        q, k, v, dout, dlse = _inputs(b, s, plain_h, d, seed=7, dtype=dtype,
                                      dv=dv)
        dlse.zero_()
        args = operands(q, k, v, dout, dlse)
    plain_ms = {
        "flash_fwd": time_ms(lambda: fk.fwd_plain(q, k, v, tables,
                                                  causal=True), 3, 1),
        "flash_bwd": time_ms(lambda: fk.bwd_plain(*args, causal=True),
                             3, 1),
    }
    del args, q, k, v, dout, dlse
    _free()
    library = {"flash_fwd": sdpa_fwd, "flash_bwd": sdpa_bwd}
    elem = torch.empty((), dtype=dtype).element_size()
    bnd = bounds(b, s, h, d, peak_flops, peak_bytes, elem, dv, rope)
    res = {name: {"ms": ms[name], "plain_ms": plain_ms[name],
                  "library_ms": library[name], **bnd[name]} for name in ms}
    emit(label, shape=dict(b=b, s=s, h=h, d=d, dv=dv or d, causal=True,
                           rope=rope, dtype=str(dtype).removeprefix("torch.")),
         bwd_kernels=fk.BWD_KERNELS[fk.route(dtype, d, dv)],
         plain_shape=dict(b=b, s=s, h=plain_h, d=d),
         sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_ms=sdpa_bwd,
         peak_flops=peak_flops, peak_bytes_per_s=peak_bytes, kernels=res)
    return res


def _moe_call_times(calls: dict, peak_bytes: float) -> dict:
    """Each of `calls` ({call: (kernel, its plain version, compulsory
    bytes, how it is held)}) run once against its plain version on the
    same card tensors ("equal": bit for bit; "dot": within
    MOE_PAIR_DOT_TOL of the plain version's largest value; "held": by the
    caller), then timed (CUDA events) beside its plain version. Returns
    {call: {ms, plain_ms, bytes, bound_ms, max_abs_err}}."""
    import torch

    res = {}
    for call, (kernel, plain, nbytes, how) in calls.items():
        err = 0.0
        if how != "held":
            a, b = kernel(), plain()
            if how == "dot":
                err = float((a - b).abs().max())
                check(err <= MOE_PAIR_DOT_TOL * float(b.abs().max()),
                      f"{call} off its plain version by {err}")
            else:
                check(torch.equal(a, b),
                      f"{call} differs from its plain version")
            del a, b
        res[call] = {"ms": time_ms(kernel), "plain_ms": time_ms(plain, 3, 3),
                     "bytes": nbytes, "bound_ms": nbytes / peak_bytes * 1e3,
                     "max_abs_err": err}
    return res


def _by_kernel(res: dict, kernel_of: dict) -> dict:
    """_moe_call_times' `res` summed by kernel (kernel_of[call]); the
    largest error."""
    out = {}
    for call, r in res.items():
        entry = out.setdefault(kernel_of[call], dict.fromkeys(r, 0.0))
        for key, value in r.items():
            entry[key] = (max(entry[key], value) if key == "max_abs_err"
                          else entry[key] + value)
    return out


def phase_moe_kernels(peak_bytes: float) -> dict:
    """The MoE layers' kernels, each call as moe.py makes it, against its
    plain version on the same card tensors, with CUDA-event times, the
    plain versions' times and each call's compulsory bytes (every input
    element the result depends on read once, every output written once)
    over `peak_bytes`: the top-1 layer's at the MoE LM cell's routing
    shapes (k = 1: route, gather_rows and combine_rows bit for bit,
    pair_dot within MOE_PAIR_DOT_TOL of its largest value), then the
    top-k layer's at the Moonlight cell's (TOPK_*: route_topk, the
    gathers and combine_rows bit for bit, pair_dot within
    MOE_PAIR_DOT_TOL). Returns {"top1" | "topk": {kernel: {ms, plain_ms,
    bound_ms, bytes, max_abs_err}}}, summed over one MoE block's
    launches of the kernel."""
    import torch

    from tpu_dra_torch.workloads import _moe_kernels as mk
    from tpu_dra_torch.workloads import moe

    t, n_exp, d = MOE_TOKENS, MOE_EXPERTS, MOE_D
    cap = moe.capacity_of(MOE_CAPACITY_FACTOR, t, n_exp)
    n_slots = n_exp * cap
    gen = torch.Generator(device="cuda").manual_seed(21)
    # Expert e drawn with weight e + 1: the last experts overflow their
    # capacity, the first leave slots empty.
    weights = torch.arange(1, n_exp + 1, dtype=torch.float32, device="cuda")
    expert = torch.multinomial(weights, t, replacement=True,
                               generator=gen).int()
    offset = torch.zeros(n_exp, dtype=torch.int32, device="cuda")
    got = mk.route(expert, offset, cap, 0, n_exp)
    want = mk.route_plain(expert, offset, cap, 0, n_exp)
    for name, a, b in zip(("pos", "slot", "token_of_slot", "counts", "kept"),
                          got, want):
        check(torch.equal(a, b), f"moe_route {name} differs from its plain "
                                 f"version")
    _, slot, token_of_slot, _, kept = got
    n_kept = int(kept[0])
    check(0 < n_kept < min(t, n_slots), f"moe_kernels kept {n_kept} of {t}")

    def randn(rows):
        return torch.randn(rows, d, generator=gen, device="cuda").bfloat16()

    x, dout, out_buf, dbuf = randn(t), randn(t), randn(n_slots), randn(n_slots)
    # The gate as the top-1 layer scales by it: rounded to the rows'
    # dtype; and each slot's token's.
    scale, gate_of_slot = moe.top1_scales(
        torch.rand(t, generator=gen, device="cuda"), token_of_slot,
        torch.bfloat16)
    row, idx4 = d * x.element_size(), 4
    # call: (kernel, plain version, compulsory bytes, how it is held)
    calls = {
        "route": (lambda: mk.route(expert, offset, cap, 0, n_exp),
                  lambda: mk.route_plain(expert, offset, cap, 0, n_exp),
                  idx4 * (t + n_exp) + idx4 * (2 * t + n_slots + n_exp + 1),
                  "held"),
        "dispatch_fwd": (
            lambda: mk.gather_rows(x, token_of_slot),
            lambda: mk.gather_rows_plain(x, token_of_slot),
            (n_kept + n_slots) * row + idx4 * n_slots, "equal"),
        "dispatch_bwd": (
            lambda: mk.combine_rows(dbuf, slot, None, 1),
            lambda: mk.combine_rows_plain(dbuf, slot, None, 1),
            (n_kept + t) * row + idx4 * t, "equal"),
        "combine_fwd": (
            lambda: mk.combine_rows(out_buf, slot, scale, 1),
            lambda: mk.combine_rows_plain(out_buf, slot, scale, 1),
            (n_kept + t) * row + 2 * idx4 * t, "equal"),
        "combine_bwd": (
            lambda: mk.gather_rows(dout, token_of_slot, gate_of_slot),
            lambda: mk.gather_rows_plain(dout, token_of_slot, gate_of_slot),
            (n_kept + n_slots) * row + 2 * idx4 * n_slots, "equal"),
        "gate_grad": (lambda: mk.pair_dot(dout, out_buf, slot, 1),
                      lambda: mk.pair_dot_plain(dout, out_buf, slot, 1),
                      2 * n_kept * row + 2 * idx4 * t, "dot"),
    }
    res = _moe_call_times(calls, peak_bytes)
    out = _by_kernel(res, {**MOE_CALL_KERNELS, "route": "moe_route"})
    emit("moe_kernels", shape=dict(tokens=t, experts=n_exp, capacity=cap,
                                   d=d, dtype="bfloat16", kept=n_kept),
         peak_bytes_per_s=peak_bytes, calls=res, kernels=out)
    del x, dout, out_buf, dbuf, calls
    _free()

    # The top-k layer: each token's TOPK_K distinct experts drawn
    # uniformly of TOPK_EXPERTS, [0, TOPK_HELD) held.
    t, k, held = TOPK_TOKENS, TOPK_K, TOPK_HELD
    chosen = torch.rand(t, TOPK_EXPERTS, generator=gen,
                        device="cuda").topk(k, -1).indices
    got = mk.route_topk(chosen, k, 0, held)
    want = mk.route_topk_plain(chosen, k, 0, held)
    n = int(want[4][0])
    for name, a, b in zip(("slot", "pair_of_row", "token_of_row", "offsets",
                           "stats"), got, want):
        if name in ("pair_of_row", "token_of_row"):   # rows [0, N) only
            a, b = a[:n], b[:n]
        check(torch.equal(a, b), f"moe_route_topk {name} differs from its "
                                 f"plain version")
    slot, pair_of_row, token_of_row = got[0], got[1][:n], got[2][:n]
    u = int(slot.view(t, k).ge(0).any(1).sum())   # tokens with a held pair
    check(0 < u < t and u < n < t * k,
          f"moe_topk_kernels held {n} pairs of {u} tokens")
    x, dout, y, dbuf = randn(t), randn(t), randn(n), randn(n)
    # The gates as topk_ffn passes them: fp32, each row's by its pair.
    gates = torch.rand(t * k, generator=gen, device="cuda") * 2.446 / k
    gate_of_row = gates[pair_of_row.long()]
    pairs = t * k
    calls = {
        "route": (lambda: mk.route_topk(chosen, k, 0, held),
                  lambda: mk.route_topk_plain(chosen, k, 0, held),
                  idx4 * pairs + idx4 * (pairs + 2 * n), "held"),
        "dispatch_fwd": (lambda: mk.gather_rows(x, token_of_row),
                         lambda: mk.gather_rows_plain(x, token_of_row),
                         u * row + idx4 * n + n * row, "equal"),
        "combine_fwd": (lambda: mk.combine_rows(y, slot, gates, k),
                        lambda: mk.combine_rows_plain(y, slot, gates, k),
                        n * row + 2 * idx4 * pairs + t * row, "equal"),
        "dispatch_bwd": (lambda: mk.combine_rows(dbuf, slot, None, k),
                         lambda: mk.combine_rows_plain(dbuf, slot, None, k),
                         n * row + idx4 * pairs + t * row, "equal"),
        "combine_bwd": (
            lambda: mk.gather_rows(dout, token_of_row, gate_of_row),
            lambda: mk.gather_rows_plain(dout, token_of_row, gate_of_row),
            u * row + 2 * idx4 * n + n * row, "equal"),
        "gate_grad": (lambda: mk.pair_dot(dout, y, slot, k),
                      lambda: mk.pair_dot_plain(dout, y, slot, k),
                      u * row + n * row + 2 * idx4 * pairs, "dot"),
    }
    res = _moe_call_times(calls, peak_bytes)
    topk = _by_kernel(res, {**MOE_CALL_KERNELS, "route": "moe_route_topk"})
    emit("moe_topk_kernels", shape=dict(tokens=t, k=k, experts=TOPK_EXPERTS,
                                        held=[0, held], d=d, dtype="bfloat16",
                                        pairs_held=n, tokens_held=u),
         peak_bytes_per_s=peak_bytes, calls=res, kernels=topk)
    del x, dout, y, dbuf, calls
    _free()
    return {"top1": out, "topk": topk}


def moe_kernel_rows(times: dict, launches: dict) -> list:
    """The kernels line's rows of the MoE kernels, per layer ("top1",
    "topk"): phase_moe_kernels' `times` (summed over one MoE block's
    launches, `timed_launches`) and the launches phase_moe (top-1) and
    phase_dsv3 (top-k) counted, {layer: {kernel: n}}."""
    replaces = {"top1": MOE_REPLACES, "topk": TOPK_REPLACES}
    return [{"name": name, "layer": layer, "route": "cuda",
             "source": SOURCES["moe_route"], "replaces": replaces[layer],
             "launches": launches[layer][name],
             "max_abs_err": t["max_abs_err"], "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": "bytes", "library_ms": None,
             "timed_launches": MOE_BLOCK_LAUNCHES[layer][name]}
            for layer, kernels in times.items()
            for name, t in kernels.items()]


def mla_kernel_rows(checks: dict, times: dict, launches: dict) -> list:
    """The kernels line's rows of the Hopper forward and fused backward at
    the Moonlight cell's attention shape, one pair per head dims of
    MLA_HEAD_DIMS: phase_kernels_mla's `checks`, the times, and the
    launches phase_dsv3 counted at the model's head dims (`launches`,
    {"DqkxDv": {kernel: n}}; None at the dims no model path of this
    script runs)."""
    rows = []
    for dims, t in times.items():
        res = checks[dims]
        err = {"flash_fwd": res["out_abs"],
               "flash_bwd": max(res[f"{n}_abs"] for n in ("dq", "dk", "dv"))}
        for wrapper, kname in (("flash_fwd", "flash_fwd_sm90"),
                               ("flash_bwd", "flash_bwd_sm90")):
            rows.append({
                "name": f"{wrapper}_mla_{dims}", "route": "cuda",
                "source": SOURCES[kname],
                "replaces": "no TPU kernel (split q.k / v head dims)",
                "launches": launches.get(dims, {}).get(kname),
                "max_abs_err": err[wrapper], "ms": t[wrapper]["ms"],
                "plain_ms": t[wrapper]["plain_ms"],
                "bound_ms": t[wrapper]["bound_ms"],
                "bound_by": t[wrapper]["bound_by"],
                "library_ms": t[wrapper]["library_ms"]})
    return rows


def phase_kernels_mla() -> dict:
    """bf16 at the Moonlight cell's attention (MLA_ATTN at S=MLA_S,
    causal, no rope in the kernels, dlse nonzero) at each of
    MLA_HEAD_DIMS, the plain versions PLAIN_HEADS heads at a time, with
    each instance's reproducibility reading. Returns {"DqkxDv":
    readings}."""
    out = {}
    for i, (dqk, dv) in enumerate(MLA_HEAD_DIMS):
        out[f"{dqk}x{dv}"] = check_case(MLA_S, True, False, seed=500 + i,
                                        chunk=PLAIN_HEADS, d=dqk, dv=dv,
                                        repro=True, **MLA_ATTN)
        _free()
    return out


def phase_times_mla(peak_flops: float, peak_bytes: float) -> dict:
    """time_kernels at the Moonlight cell's attention, for each of
    MLA_HEAD_DIMS (rope-free; plain versions at PLAIN_HEADS heads, SDPA
    at the full shape). Returns {"DqkxDv": times}."""
    return {f"{dqk}x{dv}": time_kernels(
        f"times_mla_{dqk}x{dv}", s=MLA_S, d=dqk, dv=dv, rope=False,
        peak_flops=peak_flops, peak_bytes=peak_bytes, plain_h=PLAIN_HEADS,
        inner=3, **MLA_ATTN) for dqk, dv in MLA_HEAD_DIMS}


def check_groups(args, got, window, groups) -> dict:
    """The grouped (and windowed) kernels' outputs `got` (o, lse, dq, dk,
    dv) on `args` (q, k, v, dout, lse, delta, dlse, tables) against their
    plain versions on the same tensors, for K/V heads `groups`, one query
    head at a time (the dense plain backward at S 32767 holds [B, 1, S,
    S] fp32 tensors of 4.3 GB): o, lse and dq per query head; dk and dv
    of a K/V head as its query heads' plain partials summed in fp32 (each
    rounded to bf16 first, within TOL_REL's room). Held at the (192, 128)
    instances' tolerances (TOL_REL, TOL_LSE). Returns the readings."""
    import torch

    from tpu_dra_torch.workloads import _flash_kernels as fk

    q, k, v, dout, lse, delta, dlse, tables = args
    o, lse_k, dq, dk, dv = got
    group = q.shape[2] // k.shape[2]
    names = ("out", "lse", "dq", "dk", "dv")
    diffs = {name: Diff() for name in names}
    for g in groups:
        dk_ref = dv_ref = 0
        for h in range(g * group, (g + 1) * group):
            hs, gs = slice(h, h + 1), slice(g, g + 1)
            sub = (q[:, :, hs], k[:, :, gs], v[:, :, gs], dout[:, :, hs],
                   lse[:, hs], delta[:, hs], dlse[:, hs], tables)
            o_ref, lse_ref = fk.fwd_plain(*sub[:3], tables, causal=True,
                                          window=window)
            diffs["out"].add(o[:, :, hs], o_ref)
            diffs["lse"].add(lse_k[:, hs], lse_ref)
            dq_ref, dk_h, dv_h = fk.bwd_plain(*sub, causal=True,
                                              window=window)
            diffs["dq"].add(dq[:, :, hs], dq_ref)
            dk_ref, dv_ref = dk_ref + dk_h.float(), dv_ref + dv_h.float()
            del sub, o_ref, lse_ref, dq_ref, dk_h, dv_h
        diffs["dk"].add(dk[:, :, g:g + 1], dk_ref)
        diffs["dv"].add(dv[:, :, g:g + 1], dv_ref)
        del dk_ref, dv_ref
    res = {"groups": list(groups), "lse_abs": diffs["lse"].abs,
           **{f"{n}_rel": diffs[n].rel for n in names if n != "lse"},
           **{f"{n}_abs": diffs[n].abs for n in names if n != "lse"}}
    for key in ("out_rel", "dq_rel", "dk_rel", "dv_rel"):
        check(res[key] <= TOL_REL, f"{key} {res[key]} > {TOL_REL} at "
                                   f"window {window}: {res}")
    check(res["lse_abs"] <= TOL_LSE,
          f"lse_abs {res['lse_abs']} > {TOL_LSE} at window {window}")
    return res


def phase_mimo_attention(peak_flops: float, peak_bytes: float) -> dict:
    """The Hopper kernels' grouped and window calls at the MiMo-V2-Flash
    cell's shapes (MIMO_CALLS at S=MIMO_S, (192, 128)): the forward and
    the fused backward once, held against their plain versions on the
    same tensors for the first and the last K/V head's query heads
    (check_groups); then CUDA-event times of both, the bound (bounds with
    Hkv and the window), the plain versions' times at one query head over
    one K/V head, and PyTorch's SDPA as the yardstick (GQA through
    enable_gqa; the window through a boolean band mask; None where SDPA
    refuses the shape or runs out of memory), plus the forward's (Q tile,
    K tile) visits a call (fwd_tiles x B x Hq, the counter
    attention.window_tiles) against the causal triangle's. Beside the
    global backward, its floor: the same work with K and V copied to Hq
    heads (the MHA path, no dK/dV reduce-adds), timed in turns with the
    grouped call (A B B A; `expanded_ms`, `grouped_abba_ms`). Returns
    {"global" | "window": {"checks": readings, wrapper: readings}}."""
    import torch
    import torch.nn.functional as F

    from tpu_dra_torch.workloads import _flash_kernels as fk

    out = {}
    b, s, hq, dqk, dv = 1, MIMO_S, MIMO_HEADS, 192, 128
    for kind, call in MIMO_CALLS.items():
        hkv, window = call["hkv"], call["window"]
        gen = torch.Generator(device="cuda").manual_seed(41)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)

        def operands(hq, hkv):
            q, kv = randn(b, s, hq, dqk), randn(b, s, hkv, dqk + dv)
            k, v = kv[..., :dqk], kv[..., dqk:]
            dout = randn(b, s, hq, dv)
            dlse = torch.randn(b, hq, s, generator=gen, device="cuda") * (
                0.1 if window else 0.0)
            o, lse = fk.fwd(q, k, v, None, causal=True, window=window)
            delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
            return (q, k, v, dout, lse, delta.contiguous(), dlse, None), o

        args, o = operands(hq, hkv)
        q, k, v = args[:3]
        got = (o, args[4], *fk.bwd(*args, causal=True, window=window))
        torch.cuda.synchronize()
        checks = check_groups(args, got, window, (0, hkv - 1))
        del got, o
        _free()
        ms = {"flash_fwd": time_ms(lambda: fk.fwd(q, k, v, None, causal=True,
                                                  window=window), inner=3),
              "flash_bwd": time_ms(lambda: fk.bwd(*args, causal=True,
                                                  window=window), inner=3)}
        abba = None
        if hkv != hq and not window:
            expanded = (q, fk.expand_heads(k, hq).contiguous(),
                        fk.expand_heads(v, hq).contiguous(), *args[3:])
            abba = {"grouped": [], "expanded": []}
            for name in ("grouped", "expanded", "expanded", "grouped"):
                call_args = args if name == "grouped" else expanded
                abba[name].append(time_ms(
                    lambda: fk.bwd(*call_args, causal=True), inner=3))
            del expanded
            _free()
        library = {"flash_fwd": None, "flash_bwd": None}
        qt = kt = vt = None
        try:
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            mask = (None if not window else
                    fk.band_mask(s, window, torch.device("cuda")))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=True)
            library["flash_fwd"] = time_ms(sdpa, 3, 1)
            o_t = sdpa()
            do_t = args[3].transpose(1, 2).contiguous()
            library["flash_bwd"] = time_ms(lambda: torch.autograd.grad(
                o_t, (qt, kt, vt), do_t, retain_graph=True), 3, 1)
            del o_t, do_t
        except (RuntimeError, torch.OutOfMemoryError):
            pass
        del qt, kt, vt, q, k, v, args
        _free()
        args, _ = operands(1, 1)
        q, k, v = args[:3]
        plain_ms = {
            "flash_fwd": time_ms(lambda: fk.fwd_plain(
                q, k, v, None, causal=True, window=window), 3, 1),
            "flash_bwd": time_ms(lambda: fk.bwd_plain(
                *args, causal=True, window=window), 3, 1)}
        del q, k, v, args
        _free()
        bnd = bounds(b, s, hq, dqk, peak_flops, peak_bytes, dv=dv,
                     rope=False, hkv=hkv, window=window)
        out[kind] = {name: {"ms": ms[name], "plain_ms": plain_ms[name],
                            "library_ms": library[name], **bnd[name]}
                     for name in ms}
        if abba is not None:
            out[kind]["flash_bwd"].update(
                expanded_ms=statistics.median(abba["expanded"]),
                grouped_abba_ms=statistics.median(abba["grouped"]),
                abba=abba)
        out[kind]["checks"] = checks
        emit(f"mimo_attention_{kind}",
             shape=dict(b=b, s=s, hq=hq, hkv=hkv, dqk=dqk, dv=dv,
                        window=window, causal=True, rope=False),
             fwd_tiles=b * hq * fk.fwd_tiles(s, window),
             causal_tiles=b * hq * fk.fwd_tiles(s, 0),
             plain_shape=dict(b=b, s=s, hq=1, hkv=1), **out[kind])
    return out


def mimo_kernel_rows(times: dict, launches: dict) -> list:
    """The kernels line's rows of the grouped (global) and window calls
    at the MiMo-V2-Flash cell's shapes: phase_mimo_attention's `times`
    and checks, and the launches a step of each kind phase_mimo counted
    ({"global" | "window": {kernel: n}})."""
    rows = []
    for kind, t in times.items():
        res = t["checks"]
        err = {"flash_fwd": res["out_abs"],
               "flash_bwd": max(res[f"{n}_abs"] for n in ("dq", "dk", "dv"))}
        for wrapper, kname in (("flash_fwd", "flash_fwd_sm90"),
                               ("flash_bwd", "flash_bwd_sm90")):
            rows.append({
                "name": f"{wrapper}_mimo_{kind}", "route": "cuda",
                "source": SOURCES[kname],
                "replaces": "no TPU kernel (grouped K/V heads, a window)",
                "launches": launches[kind][kname],
                "max_abs_err": err[wrapper],
                "ms": t[wrapper]["ms"], "plain_ms": t[wrapper]["plain_ms"],
                "bound_ms": t[wrapper]["bound_ms"],
                "bound_by": t[wrapper]["bound_by"],
                "library_ms": t[wrapper]["library_ms"]})
    return rows


def _ptxas(source: str) -> dict:
    """{kernel: {"registers", "stack_bytes", "spill_bytes"}} of `source`
    as ptxas -v reports them at the tree's flags."""
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.workloads import _cuda

    out = os.path.join(ROOT, "build", "ptxas_" + os.path.basename(source)
                       + ".so")
    proc = subprocess.run([gpuinfo.nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", out, os.path.join(ROOT, source)],
                          capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"ptxas -v of {source}: {proc.stderr[-2000:]}")
    rows, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Function properties for _Z\d+(\w+?)P", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            rows[name] = {"stack_bytes": int(m.group(1)),
                          "spill_bytes": int(m.group(2))}
        m = re.search(r"Used (\d+) registers", line)
        if m and name in rows:
            rows[name]["registers"] = int(m.group(1))
    return rows


def phase_kimi_kda(peak_flops: float, peak_bytes: float) -> dict:
    """The KDA chunk kernels at the Kimi Linear cell's shape (B1, KIMI_S,
    KIMI_HEADS, 128) on two sets of decays: per-head scales from 1 to 16
    times softplus (the cell's strength: a chunk's state is all but gone
    a chunk later), and the same times KDA_WEAK (the state carried over
    hundreds of chunks). On each, the forward and the backward once, held
    against the plain chunk form on the same tensors for the first and
    the last head (one head at a time: ||diff|| / ||plain|| of o, dq, dk,
    dv, dg and dbeta, each within KDA_TOL), and the launches of a lone
    call (KDA_CALL_LAUNCHES); on the first set, CUDA-event medians of the
    forward (A) and the backward (B) timed A B B A; the bound of a call
    (kda_bounds); the plain chunk form's times over all heads; ptxas's
    registers, stack and spills per kernel. Returns {"kda_fwd" |
    "kda_bwd": readings, "checks": {...}}."""
    import torch
    import torch.nn.functional as F

    from portbench.models.kimi_lm import kda_bounds
    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads import _kda_kernels as kk

    b, s, h, d = 1, KIMI_S, KIMI_HEADS, 128
    gen = torch.Generator(device="cuda").manual_seed(43)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = (F.normalize(randn(b, s, h, d), dim=-1) / math.sqrt(d)).bfloat16()
    k = F.normalize(randn(b, s, h, d), dim=-1).bfloat16()
    v = randn(b, s, h, d).bfloat16()
    a = torch.exp(torch.linspace(0.0, math.log(16.0), h, device="cuda"))
    g = (-a[:, None] * F.softplus(randn(b, s, h, d))).contiguous()
    beta = torch.sigmoid(randn(b, s, h))
    do = randn(b, s, h, d).bfloat16()
    checks = {}

    def held(args, tag):
        _cuda.reset_launches()
        o = kk.chunk_fwd(*args)
        fwd = kernel_launches(kk.ARGTYPES)
        _cuda.reset_launches()
        grads = kk.chunk_bwd(*args, do)
        bwd = kernel_launches(kk.ARGTYPES)
        torch.cuda.synchronize()
        for name, got in (("kda_fwd", fwd), ("kda_bwd", bwd)):
            want = {n: KDA_CALL_LAUNCHES[name].get(n, 0) for n in kk.ARGTYPES}
            check(got == want, f"kda {name} launches {got}, want {want}")
        for head in (0, h - 1):
            one = [x[:, :, head:head + 1].contiguous() for x in args]
            want = (kk.chunk_fwd_plain(*one),) + kk.chunk_bwd_plain(
                *one, do[:, :, head:head + 1].contiguous())
            for name, got, ref in zip(("o", "dq", "dk", "dv", "dg", "dbeta"),
                                      (o,) + grads, want):
                got = got[:, :, head:head + 1].float()
                rel = float((got - ref.float()).norm()
                            / ref.float().norm().clamp(min=1e-30))
                checks[f"{name}{tag}_h{head}"] = rel
                check(rel <= KDA_TOL,
                      f"kda {name}{tag} head {head}: {rel} > {KDA_TOL}")
            del one, want
        del o, grads
        _free()

    args = (q, k, v, g, beta)
    held(args, "")
    weak = (-(a * KDA_WEAK)[:, None] * F.softplus(randn(b, s, h, d)))
    held((q, k, v, weak.contiguous(), beta), "_weak")
    del weak
    abba = {"kda_fwd": [], "kda_bwd": []}
    for name in ("kda_fwd", "kda_bwd", "kda_bwd", "kda_fwd"):
        fn = ((lambda: kk.chunk_fwd(*args)) if name == "kda_fwd"
              else (lambda: kk.chunk_bwd(*args, do)))
        abba[name].append(time_ms(fn, reps=3, inner=2))
    plain_ms = {"kda_fwd": time_ms(lambda: kk.chunk_fwd_plain(*args), 3, 1),
                "kda_bwd": time_ms(lambda: kk.chunk_bwd_plain(*args, do),
                                   3, 1)}
    del q, k, v, g, beta, do, args
    _free()
    bnd = kda_bounds(b, s, h, d, d, peak_flops, peak_bytes)
    out = {name: {"ms": statistics.median(abba[name]), "abba": abba[name],
                  "plain_ms": plain_ms[name], "library_ms": None,
                  **bnd[name]} for name in abba}
    out["checks"] = checks
    out["ptxas"] = _ptxas(SOURCES["kda_chunk"])
    emit("kimi_kda", shape=dict(b=b, s=s, h=h, dk=d, dv=d), tol=KDA_TOL,
         weak=KDA_WEAK, **out)
    return out


def phase_kimi_mixer(peak_bytes: float) -> dict:
    """The KDA layer's fused prologue and epilogue (csrc/mixer_prep.cu)
    at the Kimi Linear cell's shape ([1, KIMI_S, KIMI_HEADS x 128] bf16):
    short_conv with the head's L2 norm and q's scale and without the norm
    (v's form), short_conv_bwd of each, gated_norm and gated_norm_bwd,
    every output held against the plain version's on the same card
    tensors (||diff|| / ||plain||, KDA_TOL); CUDA-event medians of each
    kernel (the conv in its normed form) timed in order and back, the
    plain version's time, and the compulsory bytes (MIXER_BYTES) over the
    memory rate. Returns {kernel: readings, "checks": {...}}."""
    import torch

    from tpu_dra_torch.workloads import _mixer_kernels as mx

    b, t, c = 1, KIMI_S, KIMI_HEADS * mx.HEAD
    gen = torch.Generator(device="cuda").manual_seed(28)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    l2_eps, eps, q_scale = 1e-6, 1e-5, 1.0 / math.sqrt(mx.HEAD)
    x, dout = randn(b, t, c).bfloat16(), randn(b, t, c).bfloat16()
    w = randn(mx.TAPS, c, scale=0.5)
    o, gate = randn(b, t, c).bfloat16(), randn(b, t, c).bfloat16()
    bias, scale = randn(c, scale=0.1), 1 + randn(mx.HEAD, scale=0.1)

    def conv_plain(norm, sc):
        return lambda x_, w_: mx.short_conv_plain(x_, w_, norm, sc, l2_eps,
                                                  mx.HEAD)

    def norm_plain(o_, g_, b_, s_):
        return mx.gated_norm_plain(o_, g_, b_, s_, eps)

    checks = {}

    def compare(tag, got, want):
        for name, a, ref in zip(tag.split(), got, want):
            rel = float((a.float() - ref.float()).norm()
                        / ref.float().norm().clamp(min=1e-30))
            checks[name] = rel
            check(rel <= KDA_TOL, f"mixer {name}: {rel} > {KDA_TOL}")

    for norm, sc, tag in ((True, q_scale, "norm"), (False, 1.0, "plain")):
        compare(f"conv_out_{tag}",
                (mx.short_conv(x, w, norm, sc, l2_eps),),
                (conv_plain(norm, sc)(x, w),))
        compare(f"conv_dx_{tag} conv_dw_{tag}",
                mx.short_conv_bwd(x, w, dout, norm, sc, l2_eps),
                mx._plain_grads(conv_plain(norm, sc), (x, w), dout))
        _free()
    compare("norm_out", (mx.gated_norm(o, gate, bias, scale, eps),),
            (norm_plain(o, gate, bias, scale),))
    compare("norm_do norm_dgate norm_dbias norm_dscale",
            mx.gated_norm_bwd(o, gate, bias, scale, dout, eps),
            mx._plain_grads(norm_plain, (o, gate, bias, scale), dout))
    _free()
    calls = {  # kernel: (its call, the plain version's)
        "short_conv_fwd": (
            lambda: mx.short_conv(x, w, True, q_scale, l2_eps),
            lambda: conv_plain(True, q_scale)(x, w)),
        "short_conv_bwd": (
            lambda: mx.short_conv_bwd(x, w, dout, True, q_scale, l2_eps),
            lambda: mx._plain_grads(conv_plain(True, q_scale), (x, w),
                                    dout)),
        "gated_norm_fwd": (
            lambda: mx.gated_norm(o, gate, bias, scale, eps),
            lambda: norm_plain(o, gate, bias, scale)),
        "gated_norm_bwd": (
            lambda: mx.gated_norm_bwd(o, gate, bias, scale, dout, eps),
            lambda: mx._plain_grads(norm_plain, (o, gate, bias, scale),
                                    dout)),
    }
    order = list(calls)
    runs = {name: [] for name in order}
    for name in order + order[::-1]:
        runs[name].append(time_ms(calls[name][0], reps=3, inner=5))
    out = {}
    for name, (_, plain) in calls.items():
        bound_ms = MIXER_BYTES[name] * b * t * c / peak_bytes * 1e3
        out[name] = {"ms": statistics.median(runs[name]), "runs": runs[name],
                     "plain_ms": time_ms(plain, 3, 1), "bound_ms": bound_ms,
                     "bound_by": "bytes", "library_ms": None}
    out["checks"] = checks
    del x, dout, w, o, gate, bias, scale, calls
    _free()
    emit("kimi_mixer", shape=dict(b=b, t=t, c=c), tol=KDA_TOL, **out)
    return out


def kda_kernel_rows(times: dict, launches: dict) -> list:
    """The kernels line's rows of the KDA forward and backward at the Kimi
    Linear cell's shape: phase_kimi_kda's readings, and the launches of
    each a step that phase_kimi counted ({"kda_fwd" | "kda_bwd":
    {kernel: n}})."""
    checks = times["checks"]
    err = {"kda_fwd": max(v for n, v in checks.items()
                          if n.startswith("o_")),
           "kda_bwd": max(v for n, v in checks.items()
                          if not n.startswith("o_"))}
    return [{"name": name, "route": "cuda", "source": SOURCES["kda_chunk"],
             "replaces": "no TPU kernel (the JAX package has no linear "
                         "attention)",
             "launches": sum(launches[name].values()),
             "max_rel_err": err[name], "ms": times[name]["ms"],
             "plain_ms": times[name]["plain_ms"],
             "bound_ms": times[name]["bound_ms"],
             "bound_by": times[name]["bound_by"], "library_ms": None}
            for name in ("kda_fwd", "kda_bwd")]


def mixer_kernel_rows(times: dict, launches: dict) -> list:
    """The kernels line's rows of the KDA layer's prologue and epilogue
    kernels at the Kimi Linear cell's shape: phase_kimi_mixer's readings
    (each row's error the largest of its outputs') and the launches a
    step that phase_kimi counted ({kernel: n})."""
    prefix = {"short_conv_fwd": "conv_out", "short_conv_bwd": "conv_d",
              "gated_norm_fwd": "norm_out", "gated_norm_bwd": "norm_d"}
    return [{"name": name, "route": "cuda", "source": SOURCES["mixer_prep"],
             "replaces": "no TPU kernel (the JAX package has no linear "
                         "attention)",
             "launches": launches[name],
             "max_rel_err": max(v for n, v in times["checks"].items()
                                if n.startswith(prefix[name])),
             "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
             "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
             "library_ms": None}
            for name in MIXER_BYTES]


def phase_times(peak_flops: float, peak_bytes: float) -> dict:
    return time_kernels("times", s=MAIN_S, peak_flops=peak_flops,
                        peak_bytes=peak_bytes, **FLAGSHIP_ATTN)


def phase_times_xl(peak_flops: float, peak_bytes: float) -> dict:
    return time_kernels("times_xl", s=XL_S, peak_flops=peak_flops,
                        peak_bytes=peak_bytes, plain_h=LONG_CHECK["h"],
                        inner=3, **XL_ATTN)


def phase_times_fp32(peak_flops: float, peak_bytes: float) -> dict:
    import torch

    return time_kernels("times_fp32", s=FP32_LONG_S, peak_flops=peak_flops,
                        peak_bytes=peak_bytes, dtype=torch.float32,
                        inner=3, **LONG_CHECK)


def phase_loss_head(peak_bytes: float) -> dict:
    """The loss head's kernels at each of LOSS_SHAPES (N(0, 3^2) bf16
    logits, rows 1 and 2 at +60 and -60, random targets, dnll the mean's
    1/N) against their plain versions on the same card tensors (LOSS_TOL;
    dlogits within one bf16 ulp), then CUDA-event times beside the plain
    versions and, as the yardstick the port never calls, F.cross_entropy
    on the fp32 logits (its forward; its backward alone). Compulsory
    bytes: each bf16 logit read once forward, read once and its gradient
    written once backward, and the targets, lse, nll or dnll, 16 B a row
    each way. Returns {shape: {kernel: {ms, plain_ms, library_ms, bytes,
    bound_ms, max_abs_err}}}."""
    import torch
    import torch.nn.functional as F

    from tpu_dra_torch.workloads import _loss_kernels as lk

    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for name, (n, v) in LOSS_SHAPES.items():
        logits = (torch.randn(n, v, generator=gen, device="cuda")
                  * 3).bfloat16()
        logits[1], logits[2] = 60.0, -60.0
        targets = torch.randint(0, v, (n,), generator=gen, device="cuda")
        dnll = torch.full((n,), 1.0 / n, device="cuda")
        lse, nll = lk.lse_nll(logits, targets)
        want_lse, want_nll = lk.lse_nll_plain(logits, targets)
        lse_err = float(((lse - want_lse).abs() / want_lse.abs()).max())
        nll_err = float(((nll - want_nll).abs() / torch.maximum(
            want_nll.abs(), want_lse.abs())).max())
        check(lse_err <= LOSS_TOL and nll_err <= LOSS_TOL,
              f"loss_lse_nll at {name}: lse off by {lse_err}, nll by "
              f"{nll_err} relative")
        d = lk.dlogits(logits, targets, lse, dnll)
        want_d = lk.dlogits_plain(logits, targets, lse, dnll)
        ulps = int(lk.bf16_ulps_apart(d, want_d).max())
        check(ulps <= 1, f"loss_dlogits at {name}: {ulps} bf16 ulps off")
        d_err = float((d.float() - want_d.float()).abs().max())
        del d, want_d
        x32 = logits.float().requires_grad_()
        ce = F.cross_entropy(x32, targets)
        fwd_bytes, bwd_bytes = 2 * n * v + 16 * n, 4 * n * v + 16 * n
        res = {
            "loss_lse_nll": {
                "ms": time_ms(lambda: lk.lse_nll(logits, targets)),
                "plain_ms": time_ms(lambda: lk.lse_nll_plain(logits, targets),
                                    3, 3),
                "library_ms": time_ms(lambda: F.cross_entropy(
                    x32.detach(), targets, reduction="none"), 3, 3),
                "bytes": fwd_bytes, "bound_ms": fwd_bytes / peak_bytes * 1e3,
                "max_abs_err": float((nll - want_nll).abs().max())},
            "loss_dlogits": {
                "ms": time_ms(lambda: lk.dlogits(logits, targets, lse, dnll)),
                "plain_ms": time_ms(lambda: lk.dlogits_plain(
                    logits, targets, lse, dnll), 3, 3),
                "library_ms": time_ms(lambda: torch.autograd.grad(
                    ce, x32, retain_graph=True), 3, 3),
                "bytes": bwd_bytes, "bound_ms": bwd_bytes / peak_bytes * 1e3,
                "max_abs_err": d_err},
        }
        for r in res.values():
            r["bound_share"] = r["bound_ms"] / r["ms"]
        emit("loss_head", cell=name, rows=n, vocab=v, lse_rel_err=lse_err,
             nll_rel_err=nll_err, dlogits_ulps=ulps,
             peak_bytes_per_s=peak_bytes, kernels=res)
        out[name] = res
        del logits, targets, dnll, lse, nll, want_lse, want_nll, x32, ce
        _free()
    return out


def check_loss_launches(where: str, step_calls: int, counts=None) -> dict:
    """The loss head's launch counts since the last reset (or in
    `counts`) on a bf16 model path: each kernel once per step call."""
    from tpu_dra_torch.workloads import _loss_kernels as lk

    got = kernel_launches(lk.ARGTYPES, counts)
    want = dict.fromkeys(lk.ARGTYPES, step_calls)
    check(got == want, f"loss kernel launches {got} in {where}, want {want}")
    return got


def loss_kernel_rows(times: dict, launches: dict) -> list:
    """The kernels line's rows of the loss head's kernels, one per kernel
    and shape of LOSS_SHAPES: phase_loss_head's `times` and the launches
    per step call of the main path (`launches`)."""
    return [{"name": f"{kernel}_{shape}", "route": "cuda",
             "source": SOURCES["loss_head"], "replaces": LOSS_REPLACES,
             "launches": launches[kernel], "max_abs_err": t["max_abs_err"],
             "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": "bytes",
             "library_ms": t["library_ms"]}
            for shape, kernels in times.items()
            for kernel, t in kernels.items()]


def kernel_launches(entries, counts=None) -> dict:
    """{entry: launches} of the C entry points `entries` (a kernel
    module's ARGTYPES) since the last reset, or in `counts` (_cuda's
    launches as another process read them)."""
    from tpu_dra_torch.workloads import _cuda

    counts = _cuda.launches() if counts is None else counts
    return {name: counts.get(name, 0) for name in entries}


def check_path_launches(where: str, want: int, counts=None,
                        forward_runs: int = 1) -> dict:
    """The attention kernels' launch counts since the last reset on a
    bf16 model path (or in `counts`, as another process read them): every
    forward through flash_fwd_sm90, `forward_runs` x `want` times (want =
    n_layers x step calls; forward_runs 2 where remat recomputes each
    block's forward in the backward), every backward through
    flash_bwd_sm90, `want` times, and none through the mma.sync kernels.
    Returns the attention kernels' counts."""
    from tpu_dra_torch.workloads import _flash_kernels as fk

    per_kernel = kernel_launches(fk.ARGTYPES, counts)
    kernel_want = {MODEL_PATH_KERNELS[0]: forward_runs * want,
                   MODEL_PATH_KERNELS[1]: want}
    for name, n in per_kernel.items():
        expect = kernel_want.get(name, 0)
        check(n == expect, f"kernel {name} launched {n} times in {where}, "
                           f"want {expect} (n_layers x steps = {want})")
    return per_kernel


def _nvml_inventory(backend) -> list:
    """The node's GPUs as NVML lists them, each held against torch's
    device of the same UUID: the counts agree, and every NVML GPU is a
    torch device with the same name. Each row names the fields NVML
    withheld and the CUDA driver API supplied (NativeBackend.filled)."""
    import torch

    from tpu_dra_torch.workloads.meshbuild import normalize_uuid

    gpus = backend.gpus()
    n = torch.cuda.device_count()
    check(len(gpus) == n,
          f"NVML counts {len(gpus)} GPUs, torch.cuda.device_count() {n}")
    by_uuid = {normalize_uuid(torch.cuda.get_device_properties(i).uuid): i
               for i in range(n)}
    rows = []
    for g in gpus:
        i = by_uuid.get(normalize_uuid(g.uuid))
        check(i is not None, f"NVML GPU {g.index} ({g.uuid}) is no torch "
                             f"device: torch sees {sorted(by_uuid)}")
        name = torch.cuda.get_device_name(i)
        check(g.product_name == name,
              f"NVML names GPU {g.index} {g.product_name!r}, torch "
              f"cuda:{i} {name!r}")
        rows.append({"index": g.index, "cuda": i, "uuid": g.uuid,
                     "name": g.product_name, "minor": g.minor,
                     "pci_bus_id": g.pci_bus_id,
                     "memory_bytes": g.memory_bytes,
                     "compute_capability": list(g.compute_capability),
                     "mig_mode": g.mig_mode, "clique_id": g.clique_id,
                     "coords": list(g.coords),
                     "topology": g.slice_topology,
                     "from_cuda_driver": backend.filled.get(g.index, [])})
    return rows


def _slice_check(cluster, inventory) -> list:
    """The ResourceSlice the plugin published: one device per NVML GPU,
    named gpu-{index}, with NVML's UUID and product name. Returns its
    rows."""
    from tpu_dra_torch.api.types import GPU_DRIVER_NAME
    from tpu_dra_torch.k8s import RESOURCESLICES

    slices = cluster.list(RESOURCESLICES)
    check(len(slices) == 1, f"{len(slices)} ResourceSlices published")
    spec = slices[0]["spec"]
    check(spec["driver"] == GPU_DRIVER_NAME and spec["nodeName"] == NODE,
          f"slice for {spec['driver']} on {spec['nodeName']}")
    devices = {d["name"]: d["attributes"] for d in spec["devices"]}
    check(sorted(devices) == sorted(f"gpu-{g['index']}" for g in inventory),
          f"slice devices {sorted(devices)}, NVML GPUs "
          f"{[g['index'] for g in inventory]}")
    rows = []
    for g in inventory:
        attrs = devices[f"gpu-{g['index']}"]
        check(attrs["uuid"] == {"string": g["uuid"]}
              and attrs["productName"] == {"string": g["name"]},
              f"slice device gpu-{g['index']}: {attrs}")
        rows.append({"name": f"gpu-{g['index']}",
                     "uuid": attrs["uuid"]["string"],
                     "productName": attrs["productName"]["string"],
                     "clique": attrs["clique"]["string"],
                     "fabricTopology": attrs["fabricTopology"]["string"]})
    return rows


def _registration_check(driver) -> dict:
    """As kubelet's plugin watcher: GetInfo on the registration socket
    (the driver's name, DRA v1, the DRA socket) and the registration
    status handed back."""
    from tpu_dra_torch.api.types import GPU_DRIVER_NAME
    from tpu_dra_torch.kubeletplugin import wire
    from tpu_dra_torch.kubeletplugin.server import registration_stubs

    sock = driver.server.registration_socket
    check(sock is not None and os.path.exists(sock),
          "no registration socket after the first publish")
    channel, get_info, notify = registration_stubs(sock)
    try:
        info = get_info(wire.InfoRequest(), timeout=30)
        check(info.name == GPU_DRIVER_NAME and info.type == "DRAPlugin"
              and info.supported_versions == ["v1"]
              and info.endpoint == driver.server.dra_socket,
              f"GetInfo answered {info}")
        notify(wire.RegistrationStatus(plugin_registered=True), timeout=30)
    finally:
        channel.close()
    check(driver.server.registration_registered.wait(10),
          "the registration status did not reach the plugin")
    return info.to_dict()


def _kubelet_cycle(prepare, unprepare, claim) -> tuple:
    """NodePrepareResources then (by the caller) NodeUnprepareResources
    of one claim, as kubelet sends them: (prepare response entry,
    prepare ms, unprepare callable returning its ms)."""
    from tpu_dra_torch.kubeletplugin import wire

    req = [wire.Claim(uid=claim["metadata"]["uid"],
                      name=claim["metadata"]["name"],
                      namespace=claim["metadata"]["namespace"])]
    t0 = time.perf_counter()
    resp = prepare(wire.NodePrepareResourcesRequest(claims=req))
    ms = (time.perf_counter() - t0) * 1e3
    res = resp.claims.get(claim["metadata"]["uid"])
    check(res is not None and not res.error and len(res.devices) == 1,
          f"NodePrepareResources answered {resp}")

    def undo() -> float:
        t1 = time.perf_counter()
        out = unprepare(wire.NodeUnprepareResourcesRequest(claims=req))
        undo_ms = (time.perf_counter() - t1) * 1e3
        err = out.claims.get(claim["metadata"]["uid"])
        check(err is not None and not err.error,
              f"NodeUnprepareResources answered {out}")
        return undo_ms
    return res, ms, undo


def phase_claim_path() -> dict:
    """The kubelet plugin on the card's GPUs: a GpuDriver over
    NativeBackend and a FakeCluster, its first ResourceSlice publish and
    kubelet registration, a claim for the GPU torch calls cuda:0
    prepared with NodePrepareResources over the framed socket (and over
    gRPC, where grpc imports), the flagship train step in a child
    process whose environment is that claim's CDI env, the unprepare
    over the socket; DeviceState's own prepare/unprepare times, with no
    plugin around it; bench_claim_to_ready; and one health wait. Returns
    the readings."""
    import shutil
    import tempfile

    from tpu_dra_torch import bench
    from tpu_dra_torch.api.types import GPU_DRIVER_NAME
    from tpu_dra_torch.cdi.handler import CONTROL_DEVICE_NODES, CDIHandler
    from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
    from tpu_dra_torch.gpuplugin.device_state import DeviceState
    from tpu_dra_torch.gpuplugin.driver import GpuDriver
    from tpu_dra_torch.gpuplugin.health import (
        WAIT_TIMEOUT_S, DeviceHealthMonitor,
    )
    from tpu_dra_torch.k8s import RESOURCECLAIMS, FakeCluster
    from tpu_dra_torch.kubeletplugin.server import (
        framed_stubs, kubelet_stubs, self_probe,
    )
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads.meshbuild import normalize_uuid

    backend = gpuinfo.NativeBackend()   # an NVML that fails raises here
    scratch = tempfile.mkdtemp(prefix="claim_path_",
                               dir=_cuda.BUILD_DIR.parent)
    driver = None
    try:
        inventory = _nvml_inventory(backend)
        emit("inventory", backend=backend.kind, gpus=inventory)
        emit("clique", fabric={str(k): v for k, v in backend.fabric.items()},
             gpus=[{"index": g["index"], "clique_id": g["clique_id"],
                    "topology": g["topology"], "coords": g["coords"]}
                   for g in inventory],
             missing_nvml_symbols=backend.missing_symbols)
        registration = backend.health_registration()
        emit("health_registration",
             gpus={str(k): v for k, v in registration.items()},
             not_supported=backend.health_unsupported)
        grpc_reason = bench.grpc_unavailable()
        grpc_ok = grpc_reason is None
        emit("transports", grpc=grpc_ok, framed=True)
        if not grpc_ok:
            emit("grpc_unavailable", reason=grpc_reason,
                 served="framed socket only; no kubelet registration")
        gpu = next(r for r in inventory if r["cuda"] == 0)
        plugin_dir = os.path.join(scratch, "plugin")
        cdi = CDIHandler(os.path.join(scratch, "cdi"))
        cluster = FakeCluster()
        state = DeviceState(backend=backend, cdi=cdi,
                            checkpoints=CheckpointManager(plugin_dir),
                            driver_name=GPU_DRIVER_NAME, node_name=NODE)
        driver = GpuDriver(state=state, client=cluster,
                           driver_name=GPU_DRIVER_NAME, node_name=NODE,
                           plugin_dir=plugin_dir,
                           registry_dir=os.path.join(scratch, "registry"),
                           kubelet_grpc=grpc_ok)
        t0 = time.perf_counter()
        driver.start(publish_wait=30.0)
        start_ms = (time.perf_counter() - t0) * 1e3
        check(driver.first_published.is_set(),
              "the first ResourceSlice publish did not land")
        slice_rows = _slice_check(cluster, inventory)
        info = _registration_check(driver) if grpc_ok else None
        check(self_probe(driver.server, timeout=30),
              "the plugin's self-probe failed")
        emit("plugin", start_ms=start_ms, slice=slice_rows,
             registration=info, self_probe=True,
             sockets={"grpc": driver.server.dra_socket if grpc_ok else None,
                      "framed": driver.server.fast_socket})

        allocation = {"allocation": {"devices": {"results": [{
            "request": "gpu", "driver": GPU_DRIVER_NAME, "pool": NODE,
            "device": f"gpu-{gpu['index']}"}], "config": []}}}

        def allocated(name):
            return cluster.create(RESOURCECLAIMS, {
                "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
                "metadata": {"name": name, "namespace": "default"},
                "spec": {"devices": {"requests": [{"name": "gpu"}]}},
                "status": allocation})

        client, prepare, unprepare = framed_stubs(driver.server.fast_socket,
                                                  timeout_s=60)
        try:
            claim = allocated("claim-path-0")
            uid = claim["metadata"]["uid"]
            entry, prepare_ms, undo = _kubelet_cycle(prepare, unprepare,
                                                     claim)
            check(cdi.claim_spec_exists(uid)
                  and os.path.exists(cdi.standard_spec_path()),
                  "the claim's CDI specs are not on disk")
            node = f"/dev/nvidia{gpu['minor']}"
            nodes = {p: os.path.exists(p)
                     for p in (node, *CONTROL_DEVICE_NODES)}
            check(nodes[node] and nodes["/dev/nvidiactl"],
                  f"device nodes missing: {nodes}")
            # The container runtime's view: the CDI specs the response's
            # cdi_device_ids name.
            cdi_ids = list(entry.devices[0].cdi_device_ids)
            edits = cdi.container_edits(cdi_ids)
            # The child is the container: this process's environment with
            # the claim's CDI env applied over it. CUDA is initialised
            # here, so CUDA_VISIBLE_DEVICES must reach a fresh process.
            libs_before = sorted(os.listdir(_cuda.BUILD_DIR))
            proc = subprocess.run(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 CLAIM_CHILD], env={**os.environ, **edits["env"]}, cwd=ROOT,
                capture_output=True, text=True, timeout=900)
            check(proc.returncode == 0,
                  f"claim child exited {proc.returncode}:\n{proc.stdout}\n"
                  f"{proc.stderr[-4000:]}")
            child = json.loads(proc.stdout.strip().splitlines()[-1])
            check(sorted(os.listdir(_cuda.BUILD_DIR)) == libs_before,
                  "the claim child built kernels")
            check(all(math.isfinite(x) for x in child["losses"]),
                  f"non-finite claim-path loss {child['losses']}")
            check(normalize_uuid(child["uuid"]) == normalize_uuid(gpu["uuid"]),
                  f"the child ran on {child['uuid']}, the claim holds "
                  f"{gpu['uuid']}")
            counts = check_path_launches(
                "the claim path", child["n_layers"] * child["steps"],
                child["launches"])
            unprepare_ms = undo()
        finally:
            client.close()
        check(not cdi.claim_spec_exists(uid), "claim spec left on disk")
        check(state.prepared_claim_uids() == [],
              "checkpoint still holds the claim")
        grpc_cycle = None
        if grpc_ok:
            channel, g_prepare, g_unprepare = kubelet_stubs(
                driver.server.dra_socket)
            try:
                _, g_ms, g_undo = _kubelet_cycle(
                    lambda r: g_prepare(r, timeout=60),
                    lambda r: g_unprepare(r, timeout=60),
                    allocated("claim-path-grpc"))
                grpc_cycle = {"prepare_ms": g_ms, "unprepare_ms": g_undo()}
            finally:
                channel.close()
            check(state.prepared_claim_uids() == []
                  and not cdi.list_claim_uids(),
                  "the gRPC cycle left a claim behind")
        # Host-clock spread of DeviceState alone (no plugin around it): a
        # claim prepared and unprepared CLAIM_TIMING_CYCLES times.
        cycles = {"prepare_ms": [], "unprepare_ms": []}
        for k in range(CLAIM_TIMING_CYCLES):
            direct = {"metadata": {"uid": f"claim-path-t{k}",
                                   "name": f"t{k}", "namespace": "d"},
                      "status": allocation}
            t0 = time.perf_counter()
            r = state.prepare(direct)
            t1 = time.perf_counter()
            err = state.unprepare(f"claim-path-t{k}")
            t2 = time.perf_counter()
            check(not r.error and err is None,
                  f"timing cycle {k} failed: {r.error or err}")
            cycles["prepare_ms"].append((t1 - t0) * 1e3)
            cycles["unprepare_ms"].append((t2 - t1) * 1e3)
        check(state.prepared_claim_uids() == [] and not cdi.list_claim_uids(),
              "the timing cycles left a claim behind")
        spread = {k: {"median": statistics.median(v), "min": min(v),
                      "max": max(v), "n": len(v)} for k, v in cycles.items()}
        drain_s = driver.shutdown()
        driver = None
        on_disk = CheckpointManager(plugin_dir)
        reloaded = on_disk.load()
        on_disk.close()
        check(reloaded is None or not reloaded.claims,
              "the checkpoint on disk still holds the claim")
        res = {"transport": "framed", "prepare_ms": prepare_ms,
               "unprepare_ms": unprepare_ms, "grpc_cycle": grpc_cycle,
               "drain_s": drain_s, "cycles": spread,
               "gpu": gpu["uuid"], "device": f"gpu-{gpu['index']}",
               "cdi_device_ids": cdi_ids,
               "device_nodes": nodes, "env": edits["env"],
               "mounts": [m["hostPath"] for m in edits["mounts"]],
               "child": child, "kernel_launches": counts,
               "nvidia_smi": gpuinfo.nvidia_smi()}
        emit("claim_path", **res)
        ctr = bench.bench_claim_to_ready(backend, scratch=scratch)
        check(ctr["claim_to_ready_grpc_unavailable"] == grpc_reason,
              "the bench and the probe disagree on grpc")
        emit("claim_to_ready", **ctr, nvidia_smi=gpuinfo.nvidia_smi())
        # One health wait: no event within the timeout, no wedge.
        events = []
        monitor = DeviceHealthMonitor(backend, events.append)
        monitor.start()
        time.sleep(2.5 * WAIT_TIMEOUT_S)
        monitor.stop()
        t0 = time.perf_counter()
        event = backend.wait_health_event(WAIT_TIMEOUT_S)
        waited = time.perf_counter() - t0
        check(not monitor.wedged and events == [] and event is None,
              f"health wait: wedged={monitor.wedged} events={events} "
              f"event={event}")
        emit("health", registration={str(k): v
                                     for k, v in registration.items()},
             wait_s=waited, timeout_s=WAIT_TIMEOUT_S, event=None,
             wedged=False)
        return {"claim_path": res, "claim_to_ready": ctr}
    finally:
        if driver is not None:
            driver.shutdown(drain=False)
        backend.close()
        shutil.rmtree(scratch, ignore_errors=True)


def _daemon_check(scratch: str) -> dict:
    """Start one instance of the native domain daemon (built from this
    checkout's source by phase_build) on a free port and run its own
    --check against it until it answers READY. Returns the answer."""
    from tpu_dra_torch.cddaemon import binary
    from tpu_dra_torch.testing import free_port

    daemon = binary.build()
    port = free_port()
    work = os.path.join(scratch, "daemon-check")
    os.makedirs(work)
    cfg = os.path.join(work, "daemon.cfg")
    with open(cfg, "w") as f:
        f.write(f"node_ip=127.0.0.1\nport={port}\n"
                f"nodes_config={os.path.join(work, 'nodes.cfg')}\n"
                f"clique_id=\nworker_index=0\n")
    proc = subprocess.Popen([daemon, "--config", cfg],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        answer, deadline = None, time.monotonic() + 10
        while time.monotonic() < deadline:
            probe = subprocess.run([daemon, "--check", "--port", str(port)],
                                   capture_output=True, text=True,
                                   timeout=10)
            if probe.returncode == 0:
                answer = probe.stdout.strip()
                break
            time.sleep(0.05)
        check(answer is not None and answer.startswith("READY"),
              f"the domain daemon never answered READY on port {port}")
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    return {"binary": os.path.relpath(daemon, ROOT), "check": answer}


def phase_compute_domain() -> dict:
    """The compute-domain stack: (a) the native domain daemon built and
    READY by its own --check; (b) a two-node ComputeDomain of simulated
    nodes through the controller, two CD kubelet plugins and two real
    daemons over a FakeCluster, from creation to both channel claims
    prepared (cd_convergence_s, host time); (c) a one-node domain on
    this host — a GpuDriver over NVML prepares a claim of the GPU torch
    calls cuda:0 over its framed socket, the CD plugin (its clique read
    through NVML) prepares a channel claim on the same node, and the two
    CDI envs, merged, are the environment of a claim child that plans
    with plan_from_env, starts the node's NCCL group of the domain (world
    1) at the env's MASTER_ADDR:MASTER_PORT and runs the flagship train
    step at full width for CLAIM_STEPS steps (launch counts zeroed just
    before); (d) the domain torn down: no node label, stamped DaemonSet
    or template left. Returns the readings."""
    import shutil
    import tempfile

    import torch

    from tpu_dra_torch import bench
    from tpu_dra_torch.api.types import GPU_DRIVER_NAME
    from tpu_dra_torch.cdi.handler import CDIHandler
    from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
    from tpu_dra_torch.gpuplugin.device_state import DeviceState
    from tpu_dra_torch.gpuplugin.driver import GpuDriver
    from tpu_dra_torch.k8s import RESOURCECLAIMS
    from tpu_dra_torch.kubeletplugin.server import framed_stubs
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.testing import DomainSim
    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads.meshbuild import normalize_uuid

    scratch = tempfile.mkdtemp(prefix="cd_", dir=_cuda.BUILD_DIR.parent)
    backend = gpuinfo.NativeBackend()
    driver = None
    try:
        daemon = _daemon_check(scratch)
        emit("cd_daemon", **daemon)
        two = bench.bench_cd_convergence()
        emit("cd_convergence", cd_convergence_s=two["cd_convergence_s"],
             clock="host", host=os.uname().nodename, envs=two["envs"])
        t0 = time.perf_counter()
        with DomainSim({NODE: backend}, namespace="smoke",
                       root=os.path.join(scratch, "domain")) as sim:
            cd = sim.create_cd("card-cd")
            prov = sim.prepare_channels(cd)
            check(prov["ok"], f"the card's domain did not converge: "
                              f"{prov['error']}")
            channel_env = prov["envs"][NODE]
            converge_s = time.perf_counter() - t0
            node = sim.nodes[0]
            cuda0 = normalize_uuid(torch.cuda.get_device_properties(0).uuid)
            gpu = next(g for g in backend.gpus()
                       if normalize_uuid(g.uuid) == cuda0)
            plugin_dir = os.path.join(scratch, "gpu-plugin")
            cdi = CDIHandler(os.path.join(scratch, "cdi"))
            state = DeviceState(backend=backend, cdi=cdi,
                                checkpoints=CheckpointManager(plugin_dir),
                                driver_name=GPU_DRIVER_NAME, node_name=NODE)
            driver = GpuDriver(state=state, client=sim.cluster,
                               driver_name=GPU_DRIVER_NAME, node_name=NODE,
                               plugin_dir=plugin_dir,
                               kubelet_grpc=bench.grpc_unavailable() is None)
            driver.start(publish_wait=30.0)
            claim = sim.cluster.create(RESOURCECLAIMS, {
                "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
                "metadata": {"name": "cd-gpu", "namespace": "smoke"},
                "spec": {"devices": {"requests": [{"name": "gpu"}]}},
                "status": {"allocation": {"devices": {"results": [{
                    "request": "gpu", "driver": GPU_DRIVER_NAME,
                    "pool": NODE, "device": f"gpu-{gpu.index}"}],
                    "config": []}}}})
            client, prepare, unprepare = framed_stubs(
                driver.server.fast_socket, timeout_s=60)
            try:
                entry, _, undo = _kubelet_cycle(prepare, unprepare, claim)
                gpu_env = cdi.container_edits(
                    list(entry.devices[0].cdi_device_ids))["env"]
                merged = {**gpu_env, **channel_env}
                proc = subprocess.run(
                    [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                     CLAIM_CHILD, "--steps", str(CLAIM_STEPS)],
                    env={**os.environ, **merged}, cwd=ROOT,
                    capture_output=True, text=True, timeout=900)
                check(proc.returncode == 0,
                      f"domain claim child exited {proc.returncode}:\n"
                      f"{proc.stdout}\n{proc.stderr[-4000:]}")
                child = json.loads(proc.stdout.strip().splitlines()[-1])
                undo()
            finally:
                client.close()
            check(all(math.isfinite(x) for x in child["losses"]),
                  f"non-finite domain-child loss {child['losses']}")
            check(normalize_uuid(child["uuid"]) == normalize_uuid(gpu.uuid),
                  f"the domain child ran on {child['uuid']}, the claim "
                  f"holds {gpu.uuid}")
            rendezvous = (f"{channel_env['MASTER_ADDR']}:"
                          f"{channel_env['MASTER_PORT']}")
            place = child["domain"]
            check(place["rendezvous"] == rendezvous
                  and (place["rank"], place["world"], place["psum"])
                  == (0, 1, 1.0) and child["n_devices"] == 1,
                  f"the child took {place} on a plan of "
                  f"{child['n_devices']}; the env names {rendezvous}")
            counts = check_path_launches(
                "the compute-domain child", child["n_layers"] * child["steps"],
                child["launches"])
            left = sim.teardown(cd, prov["claims"])
            check(left["cd_deleted"] and not left["labeled_nodes"]
                  and not left["daemonsets"] and not left["templates"]
                  and not left["unprepare_errors"],
                  f"the domain's teardown left {left}")
            check(node.daemon is None, "a domain daemon still runs")
        res = {"daemon": daemon,
               "cd_convergence_s": two["cd_convergence_s"],
               "card_domain_s": converge_s, "clique_id": node.clique_id,
               "channel_env": channel_env,
               "merged_keys": sorted(merged),
               "rendezvous": rendezvous,
               "median_step_s": statistics.median(child["step_times_s"]),
               "losses": child["losses"], "steps": child["steps"],
               "n_layers": child["n_layers"], "kernel_launches": counts,
               "teardown": left, "nvidia_smi": gpuinfo.nvidia_smi()}
        emit("compute_domain", **res)
        return res
    finally:
        if driver is not None:
            driver.shutdown(drain=False)
        backend.close()
        shutil.rmtree(scratch, ignore_errors=True)


def _cluster_env() -> dict:
    """What the cluster tier can use on this machine: PyYAML (only the
    chart's render needs it), grpc (kubelet's transport; NodeSim falls
    back to the framed socket), and cryptography or the openssl CLI (the
    webhook's serving cert)."""
    import importlib.util
    import shutil

    return {m: importlib.util.find_spec(m) is not None
            for m in ("yaml", "grpc", "cryptography")} | {
        "openssl": shutil.which("openssl")}


def _wait(pred, timeout: float, interval: float = 0.05):
    """pred() until it returns something truthy (returned), or None at
    the timeout; an exception in pred counts as not yet."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        try:
            got = pred()
        except Exception:  # noqa: BLE001 # drflow: swallow-ok[an API read racing a write counts as not yet; the deadline bounds the wait]
            got = None
        if got:
            return got
        time.sleep(interval)
    return None


def _webhook_denies(cluster, ns: str) -> str:
    """Once the webhook pod reads Ready, a claim whose GpuConfig carries
    an unknown field must be refused at admission. Returns the denial."""
    from tpu_dra_torch.api.types import API_VERSION, GPU_DRIVER_NAME
    from tpu_dra_torch.k8s import PODS, RESOURCECLAIMS
    from tpu_dra_torch.k8s.client import ApiError

    def ready():
        return any(c.get("type") == "Ready" and c.get("status") == "True"
                   for p in cluster.api.list(PODS, namespace=ns)
                   if p["metadata"]["name"].startswith("gpu-dra-driver-webhook")
                   for c in (p.get("status") or {}).get("conditions") or [])

    check(_wait(ready, 120, 0.2), "the webhook pod never read Ready")
    bad = {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
           "metadata": {"name": "bad-config", "namespace": "default"},
           "spec": {"devices": {
               "requests": [{"name": "gpu", "exactly": {
                   "deviceClassName": "gpu.dev"}}],
               "config": [{"requests": ["gpu"], "opaque": {
                   "driver": GPU_DRIVER_NAME,
                   "parameters": {"apiVersion": API_VERSION,
                                  "kind": "GpuConfig", "bogus": 1}}}]}}}
    try:
        cluster.api.create(RESOURCECLAIMS, bad, namespace="default")
    except ApiError as e:
        check("denied" in str(e), f"admission failed, not denied: {e}")
        return str(e)
    raise RuntimeError("chip_smoke check failed: the webhook admitted a "
                       "GpuConfig with an unknown field")


def phase_cluster(claim_path_child: dict) -> dict:
    """The cluster tier on the card: a SimCluster whose one node, n0, is
    this host (its plugins read NVML); the driver installed from
    manifests.all_manifests() (the chart's render); the plugin pod's
    ResourceSlice holding the card's UUID; then the exclusive-GPU demo,
    one pod whose claim comes from a template and whose container runs
    `python -m tpu_dra_torch.bench claim-child --steps CLAIM_STEPS`.
    The scheduler allocates the claim, NodeSim prepares it over the
    plugin's dra.sock and runs the container with the claim's CDI env.
    Checks: Succeeded, the claim on the card's UUID and the child on the
    same, finite losses, n_layers x steps launches of each Hopper kernel
    and none of the mma.sync ones; after the pod's deletion the claim is
    gone, no claim spec is left in the node's CDI root and, once the
    plugin has stopped, no claim in its checkpoint. Reads pod create ->
    Running and -> Succeeded (host clock) and the child's median step
    beside claim_path's child's."""
    import shutil

    from tpu_dra_torch.api.types import GPU_DRIVER_NAME
    from tpu_dra_torch.cdi.handler import CDIHandler
    from tpu_dra_torch.deploy import demos, manifests
    from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
    from tpu_dra_torch.k8s import PODS, RESOURCECLAIMS, RESOURCESLICES
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.simcluster import SimCluster
    from tpu_dra_torch.simcluster.cluster import short_workdir
    from tpu_dra_torch.workloads.meshbuild import normalize_uuid

    t_phase = time.perf_counter()
    env = _cluster_env()
    emit("cluster_env", **env)
    backend = gpuinfo.NativeBackend()
    try:
        gpu = next(r for r in _nvml_inventory(backend) if r["cuda"] == 0)
    finally:
        backend.close()
    try:
        docs = manifests.all_manifests()
        webhook = "on"
    except Exception as e:  # noqa: BLE001 — no cryptography, no openssl
        docs = manifests.render({"webhook": {"enabled": False}})
        webhook = f"off: {e}"
    work = short_workdir()
    cluster = SimCluster(work, num_nodes=1, card_node=True)
    ns = manifests.DEFAULT_NAMESPACE
    try:
        t0 = time.perf_counter()
        cluster.start()
        n_docs = cluster.install(docs)

        def card_slice():
            for sl in cluster.api.list(RESOURCESLICES):
                if sl["spec"].get("driver") != GPU_DRIVER_NAME:
                    continue
                for d in sl["spec"].get("devices") or []:
                    uuid = d["attributes"].get("uuid", {}).get("string")
                    if normalize_uuid(uuid or "") == normalize_uuid(
                            gpu["uuid"]):
                        return d["name"]
            return None

        device = _wait(card_slice, 180, 0.1)
        check(device is not None,
              "the plugin pod never published the card's UUID")
        slice_s = time.perf_counter() - t0
        denial = _webhook_denies(cluster, ns) if webhook == "on" else None
        demo = demos.test1_exclusive_per_pod(
            demos.claim_child_command(CLAIM_STEPS), pods=1)
        pod_doc = demo[-1]
        pns = pod_doc["metadata"]["namespace"]
        cluster.install(demo[:-1])
        t_create = time.perf_counter()
        cluster.install([pod_doc])
        phases = {}

        def phase():
            p = cluster.api.get(PODS, "pod0", pns)
            ph = (p.get("status") or {}).get("phase", "Pending")
            if ph not in phases:
                phases[ph] = time.perf_counter() - t_create
            return p if ph in ("Succeeded", "Failed") else None

        started = _wait(lambda: phase() or set(phases) - {"Pending"},
                        POD_START_TIMEOUT_S, 0.05)
        check(started, "the demo pod stayed Pending: "
              f"{cluster.api.get(PODS, 'pod0', pns).get('status')}")
        pod = _wait(phase, 900, 0.05)
        check(pod is not None, f"the demo pod never ended: {phases}")
        log_text = cluster.pod_log(pod, "ctr")
        check(pod["status"]["phase"] == "Succeeded",
              f"the demo pod {pod['status']['phase']}:\n{log_text[-4000:]}")
        check("Running" in phases, f"the pod was never seen Running: "
                                   f"{phases}")
        claim_name = pod["status"]["resourceClaimStatuses"][0][
            "resourceClaimName"]
        claim = cluster.api.get(RESOURCECLAIMS, claim_name, pns)
        results = claim["status"]["allocation"]["devices"]["results"]
        check([(r["driver"], r["pool"], r["device"]) for r in results]
              == [(GPU_DRIVER_NAME, "n0", device)],
              f"the claim is allocated to {results}, want {device} on n0")
        child = json.loads(log_text.strip().splitlines()[-1])
        check(all(math.isfinite(x) for x in child["losses"]),
              f"non-finite cluster-pod loss {child['losses']}")
        check(normalize_uuid(child["uuid"]) == normalize_uuid(gpu["uuid"]),
              f"the pod ran on {child['uuid']}, the claim holds "
              f"{gpu['uuid']}")
        counts = check_path_launches(
            "the cluster pod", child["n_layers"] * child["steps"],
            child["launches"])
        cluster.api.delete(PODS, "pod0", pns)
        check(_wait(lambda: not cluster.api.list(RESOURCECLAIMS,
                                                 namespace=pns), 60, 0.1),
              "the template claim outlived its pod")
        cdi_root = os.path.join(cluster.node_dir("n0"), "fs", "var", "run",
                                "cdi")
        left = CDIHandler(cdi_root).list_claim_uids()
        check(left == [], f"claim specs left in the CDI root: {left}")
    finally:
        cluster.stop()
    plugin_dir = os.path.join(cluster.node_dir("n0"), "fs", "var", "lib",
                              "kubelet", "plugins", GPU_DRIVER_NAME)
    on_disk = CheckpointManager(plugin_dir)
    reloaded = on_disk.load()
    on_disk.close()
    shutil.rmtree(work, ignore_errors=True)
    check(reloaded is None or not reloaded.claims,
          "the plugin's checkpoint still holds the claim")
    res = {"objects_installed": n_docs, "slice_s": slice_s,
           "webhook": webhook, "webhook_denial": denial,
           "transport": "grpc" if env["grpc"] else "framed",
           "gpu": gpu["uuid"], "device": device,
           "pod_running_s": phases["Running"],
           "pod_succeeded_s": phases["Succeeded"],
           "child_median_step_ms": statistics.median(
               child["step_times_s"]) * 1e3,
           "claim_path_child_median_step_ms": statistics.median(
               claim_path_child["step_times_s"]) * 1e3,
           "losses": child["losses"], "kernel_launches": counts,
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": gpuinfo.nvidia_smi()}
    emit("cluster", **res)
    return res


def phase_e2e() -> dict:
    """`python -m tpu_dra_torch.e2e --card-node` in a child process: the
    ten suites against a two-node SimCluster whose n0 is this host. One
    e2e_suite line per suite; every suite must pass and the child exit
    0. gpu_claims' training pod ran on n0, on the card: its losses
    finite and its launch counts checked as on the main path."""
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.workloads.meshbuild import normalize_uuid

    import signal
    import threading

    t_phase = time.perf_counter()
    os.makedirs(os.path.dirname(E2E_LOG), exist_ok=True)
    records = {}
    with open(E2E_LOG, "w") as err:
        # A session of its own: at the time limit the child, its
        # cluster and every pod process go together.
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_dra_torch.e2e", "--card-node"],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
            stdout=subprocess.PIPE, stderr=err, text=True,
            start_new_session=True)
        timer = threading.Timer(
            E2E_TIMEOUT_S, lambda: os.killpg(proc.pid, signal.SIGKILL))
        timer.start()
        try:
            for line in proc.stdout:
                if line.startswith('{"suite"'):
                    rec = json.loads(line)
                    records[rec["suite"]] = rec
                    emit("e2e_suite", **{
                        k: v for k, v in rec.items()
                        if k != "train" and (k != "traceback"
                                             or not rec["ok"])})
            rc = proc.wait()
        finally:
            timer.cancel()
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    with open(E2E_LOG) as f:
        err_tail = f.read()[-4000:]
    failed = [n for n, r in records.items() if not r["ok"]]
    check(rc == 0 and not failed,
          f"e2e exited {rc} (killed at {E2E_TIMEOUT_S} s: {rc == -9}), "
          f"failed suites {failed}; ran {list(records)}:\n{err_tail}")
    check(list(records) == ["up", *E2E_SUITES],
          f"e2e ran {list(records)}, want up then {list(E2E_SUITES)}")
    train = records["gpu_claims"]["train"]
    check(train["node"] == "n0", f"the training pod ran on {train['node']}")
    check(normalize_uuid(train["uuid"] or "") == normalize_uuid(
        train["claim_uuids"][0]), f"the training pod ran on {train['uuid']},"
        f" its claim holds {train['claim_uuids']}")
    check(train["device"].startswith("cuda") and all(
        math.isfinite(x) for x in train["losses"]),
        f"the e2e training pod: {train['device']}, {train['losses']}")
    counts = check_path_launches(
        "the e2e training pod", train["n_layers"] * train["steps"],
        train["launches"])
    res = {"suites_s": {n: r["seconds"] for n, r in records.items()},
           "stress_churn_p95_s": records["stress"]["churn_p95_s"],
           "cd_failover": {k: records["cd_failover"][k] for k in (
               "fault_status", "heal_daemons_s", "heal_worker_s")},
           "train_uuid": train["uuid"], "losses": train["losses"],
           "train_median_step_ms": statistics.median(
               train["step_times_s"]) * 1e3,
           "kernel_launches": counts,
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": gpuinfo.nvidia_smi()}
    emit("e2e", **res)
    return res


def phase_hot_restart() -> dict:
    """bench_hot_restart on the card's NativeBackend: HOT_RESTART_WORKERS
    client threads on RetryingFramedClient prepare and unprepare claims
    of the GPU torch calls cuda:0 for HOT_RESTART_S seconds while the
    plugin restarts HOT_RESTARTS times on the same dirs. Checks 0 failed
    RPCs, 0 leaked claims, at least one reconnect per restart; reads the
    drain seconds and the RPCs' p50 and p99."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.workloads import _cuda

    t_phase = time.perf_counter()
    backend = gpuinfo.NativeBackend()
    try:
        res = bench.bench_hot_restart(
            backend, duration_s=HOT_RESTART_S, workers=HOT_RESTART_WORKERS,
            gpus_per_worker=1, n_restarts=HOT_RESTARTS,
            scratch=_cuda.BUILD_DIR.parent)
    finally:
        backend.close()
    check(res["hot_restart_failed_rpcs"] == 0,
          f"hot restart: {res['hot_restart_failed_rpcs']} failed RPCs "
          f"({res.get('hot_restart_first_error')})")
    check(res["hot_restart_leaked_claims"] == 0,
          f"hot restart leaked {res['hot_restart_leaked_claims']} claims")
    per_restart = res["hot_restart_reconnects_per_restart"]
    check(len(per_restart) == HOT_RESTARTS and min(per_restart) >= 1,
          f"hot restart: reconnects per restart {per_restart} for "
          f"{HOT_RESTARTS} restarts (at least 1 each)")
    emit("hot_restart", **res, phase_s=time.perf_counter() - t_phase,
         nvidia_smi=gpuinfo.nvidia_smi())
    return res


def _check_ops(name: str, rec: dict) -> None:
    """The invariants hack/perf.sh holds each ops bench to."""
    if name == "fake_inventory":
        errors = {k: v for k, v in rec.items() if k.endswith("_error")}
        check(not errors, f"fake inventory: sections failed: {errors}")
        for key in ("claim_to_ready_p50_subslice_fake_h100_ms",
                    "claim_to_ready_p50_multiprocess_ms"):
            check(rec.get(key) is not None, f"fake inventory: {key} is null")
    elif name == "prepare_sustained":
        check(rec["prepare_sustained_errors"] == 0,
              f"sustained: {rec['prepare_sustained_errors']} RPC errors "
              f"({rec.get('prepare_sustained_first_error')})")
        check(rec["prepare_sustained_leaked_claims"] == 0,
              f"sustained: {rec['prepare_sustained_leaked_claims']} claims "
              "leaked")
        check(rec["prepare_sustained_pipeline_inflight_peak"]
              <= OPS_INFLIGHT_MAX,
              f"sustained: pipeline in-flight peak "
              f"{rec['prepare_sustained_pipeline_inflight_peak']} > "
              f"{OPS_INFLIGHT_MAX}")
    elif name == "sched_churn":
        check(rec["sched_full_relists"] == 0,
              f"churn: {rec['sched_full_relists']} full relists")
        check(rec["sched_cel_compiles"] <= rec["sched_cel_distinct_exprs"],
              f"churn: {rec['sched_cel_compiles']} CEL compiles for "
              f"{rec['sched_cel_distinct_exprs']} expressions")
        check("sched_churn_gc_leak" not in rec,
              f"churn: {rec.get('sched_churn_gc_leak')} claims leaked")
        check(rec.get("sched_workers") == SCHED_WORKERS,
              f"churn: the scheduler ran {rec.get('sched_workers')} "
              f"workers, not its pool of {SCHED_WORKERS}")
    elif name == "topology":
        check(rec["topo_contiguity_ratio"] == 1.0,
              f"topology: contiguity {rec['topo_contiguity_ratio']}")
        check(rec["topo_unplaced_pods"] == 0,
              f"topology: {rec['topo_unplaced_pods']} pods unplaced")
    elif name == "sched_failover":
        check(rec["sched_failover_to_alloc_p50_ms"]
              <= OPS_FAILOVER_P50_GATE_MS,
              f"failover p50 {rec['sched_failover_to_alloc_p50_ms']} ms > "
              f"{OPS_FAILOVER_P50_GATE_MS}")


def phase_ops() -> dict:
    """tpu_dra_torch.bench.ops_benches on this host (no GPU): each
    bench's record, checked by _check_ops, on a line of its own."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.native import gpuinfo

    t_phase = time.perf_counter()
    res = {}
    for name, rec in bench.ops_benches(sustained_s=OPS_SUSTAINED_S):
        emit(f"ops_{name}", **rec)
        _check_ops(name, rec)
        res[name] = rec
    emit("ops", benches=list(res), phase_s=time.perf_counter() - t_phase,
         nvidia_smi=gpuinfo.nvidia_smi())
    return res


def _chaos_walk_line(rec: dict, rearm_sites) -> dict:
    """One walk's record for the chaos line: its counts, its violations
    and the re-arm sites that never fired across the seeds."""
    injected = rec["injected"]
    return {"schedules": rec["schedules"], "events": rec["events"],
            "injected": injected, "violations": rec["violations"],
            "unfired_sites": sorted(s for s in rearm_sites
                                    if not injected.get(s))}


def phase_chaos() -> dict:
    """The chaos tier (tpu_dra_torch.simcluster.chaos) at CHAOS_SEEDS x
    CHAOS_EVENTS with the port's lock witness installed across the whole
    matrix (the harnesses' own installs nest in it, so the graph holds
    every walk) and one untimed crash recovery on the card's
    NativeBackend: zero violations in every walk and the watch-flake
    scenario, no lock-order cycle. The witnessed edges are exported to
    CHAOS_EDGES for the analysis phase. Then, outside the witness,
    bench_chaos_recovery on the fake node and on the card's
    NativeBackend."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.infra import lockwitness
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.simcluster import chaos

    t_phase = time.perf_counter()
    os.makedirs(ANALYSIS_DIR, exist_ok=True)
    if os.path.exists(CHAOS_EDGES):
        os.unlink(CHAOS_EDGES)
    lockwitness.install()
    try:
        summary = chaos.walk_matrix(list(range(CHAOS_SEEDS)), CHAOS_EVENTS)
        matrix_s = time.perf_counter() - t_phase
        backend = gpuinfo.NativeBackend()
        try:
            witnessed = bench.bench_chaos_recovery(CHAOS_RECOVERY_CRASHES,
                                                   backend=backend)
        finally:
            backend.close()
        cycles = lockwitness.WITNESS.cycles()
        edges = len(lockwitness.WITNESS.edges())
        # The card run's own edges, for the analysis phase's
        # observed-within-static check.
        exported = lockwitness.export_edges(CHAOS_EDGES)
    finally:
        lockwitness.uninstall()
    walks = {"plugin": _chaos_walk_line(summary,
                                        chaos.REARM_SITES["plugin"])}
    for walk in chaos.WALKS:
        walks[walk] = _chaos_walk_line(summary[walk],
                                       chaos.REARM_SITES[walk])
    fake = bench.bench_chaos_recovery(CHAOS_RECOVERY_CRASHES)
    backend = gpuinfo.NativeBackend()
    try:
        nvml = bench.bench_chaos_recovery(CHAOS_RECOVERY_CRASHES,
                                          backend=backend)
    finally:
        backend.close()
    res = {"cut": f"{CHAOS_SEEDS} seeds x {CHAOS_EVENTS} events "
                  "(hack/chaos.sh: 25 x 60)",
           "walks": walks,
           "watch_flake_violations": summary["watch_flake_violations"],
           "witness_cycles": cycles, "witness_edges": edges,
           "witness_export": exported, "matrix_s": matrix_s,
           "recovery_fake": fake, "recovery_nvml": nvml,
           "witnessed_recovery_nvml": witnessed,
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": gpuinfo.nvidia_smi()}
    emit("chaos", **res)
    for walk, rec in walks.items():
        check(not rec["violations"],
              f"chaos: {walk} walk violations: {rec['violations'][:5]}")
    check(not summary["watch_flake_violations"],
          f"chaos: watch flake: {summary['watch_flake_violations']}")
    check(not cycles, f"chaos: lock-order cycles: {cycles}")
    check(exported == CHAOS_EDGES, f"chaos: witness export {exported}")
    for name, rec in (("fake", fake), ("nvml", nvml),
                      ("witnessed nvml", witnessed)):
        check(rec["chaos_recovery_crashes"] == CHAOS_RECOVERY_CRASHES
              and rec["chaos_recovery_p50_ms"] > 0,
              f"chaos: crash recovery on {name}: {rec}")
    return res


def _run_module(args, timeout: float, env=None):
    """`python -m <args>` from the checkout's root, output captured; the
    wall seconds beside the completed process."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          env={**os.environ, **(env or {})},
                          capture_output=True, text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def _check_line(out: str, kind: str) -> dict:
    """The counts of dralint's ``witness:`` / ``viewshadow:`` summary."""
    pat = {"witness": r"witness: (\d+) observed edge\(s\), (\d+) static, "
                      r"(\d+) unexplained",
           "viewshadow": r"viewshadow: (\d+) observed drift\(s\), (\d+) "
                         r"recognized view site\(s\), (\d+) unexplained"}
    m = re.search(pat[kind], out)
    check(m is not None, f"analysis: no {kind} summary in {out[-400:]!r}")
    a, b, c = map(int, m.groups())
    keys = (("observed", "static", "unexplained") if kind == "witness"
            else ("drifts", "recognized_sites", "unexplained"))
    return dict(zip(keys, (a, b, c)))


def _drmc(args, timeout: float) -> tuple:
    proc, secs = _run_module(
        ["tpu_dra_torch.analysis.drmc", *args, "--json"], timeout,
        env={"TPU_DRA_LOCK_WITNESS_EXPORT": DRMC_EDGES})
    check(proc.returncode == 0 and proc.stdout.strip().startswith("{"),
          f"analysis: drmc {args} exited {proc.returncode}: "
          f"{(proc.stdout + proc.stderr)[-800:]}")
    return json.loads(proc.stdout), secs


def phase_analysis() -> dict:
    """The port's analysis tier on the card's host (host clock): dralint
    (R1-R15) cold over its default paths with --require-justified, the
    chaos phase's witnessed edges and drmc's held against the static
    lock-order graph, drmc at hack/drmc.sh's sizes, the view-shadow walk
    held against R13, and MeshSliceHarness(2, 4)'s plan."""
    from tpu_dra_torch.k8s import informer
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.simcluster import chaos
    from tpu_dra_torch.testing import MeshSliceHarness
    from tpu_dra_torch.topology.meshexport import plan_from_worker_envs

    t_phase = time.perf_counter()
    os.makedirs(ANALYSIS_DIR, exist_ok=True)
    for path in (DRMC_EDGES, VIEW_DRIFTS):
        if os.path.exists(path):
            os.unlink(path)
    # 1. The cold whole-tree gate (no result cache read or written).
    proc, lint_s = _run_module(
        ["tpu_dra_torch.analysis", "--root", ROOT, "--no-cache",
         "--jobs", "auto", "--require-justified", "--json"],
        LINT_COLD_LIMIT_S)
    check(proc.stdout.strip().startswith("{"),
          f"analysis: dralint printed no report: {proc.stderr[-800:]}")
    doc = json.loads(proc.stdout)
    lint = {"files": doc["files"], "findings": len(doc["findings"]),
            "suppressed": len(doc["suppressed"]),
            "unjustified": len(doc["suppressed_unjustified"]),
            "findings_by_rule": doc["findings_by_rule"],
            "suppressed_by_rule": doc["suppressed_by_rule"],
            "seconds": lint_s, "limit_s": LINT_COLD_LIMIT_S,
            "returncode": proc.returncode}
    # 2. drmc: the gate, then the three dedicated floors, every run
    # exporting its witness's edges.
    gate, gate_s = _drmc(DRMC_GATE, 600)
    floors = {}
    floors_s = 0.0
    for name in DRMC_FLOORS:
        floors[name], secs = _drmc(["--scenario", name, *DRMC_FLOOR_ARGS],
                                   300)
        floors_s += secs
    drmc = {
        "schedules": {e["scenario"]: e["distinct"] for e in gate["explore"]},
        "distinct_total": gate["distinct_total"],
        "crash_points": {c["scenario"]: c["points_run"]
                         for c in gate["crash"]},
        "crash_enumerated": {c["scenario"]: c["points_enumerated"]
                             for c in gate["crash"]},
        "floors": {n: d["explore"][0]["distinct"]
                   for n, d in floors.items()},
        "gate_s": gate_s, "floors_s": floors_s}
    # 3. The view-shadow walk (drifts exported for the check below).
    os.environ[informer.ViewShadow.EXPORT_ENV] = VIEW_DRIFTS
    try:
        walk = chaos.run_sched_schedule(*VIEW_SHADOW_WALK)
    finally:
        os.environ.pop(informer.ViewShadow.EXPORT_ENV, None)
    # 4. observed within static: the card run's chaos edges and the view
    # drifts in one scan (it writes the port's result cache), drmc's
    # edges in a second (warm) one.
    proc, chaos_check_s = _run_module(
        ["tpu_dra_torch.analysis", "--root", ROOT, "--check-witness",
         CHAOS_EDGES, "--check-view-shadow", VIEW_DRIFTS], 300)
    out = proc.stdout + proc.stderr
    witness_chaos = {**_check_line(out, "witness"),
                     "returncode": proc.returncode}
    view = {**_check_line(out, "viewshadow"), "walk_ok": walk.ok,
            "walk_violations": walk.violations[:5]}
    proc, drmc_check_s = _run_module(
        ["tpu_dra_torch.analysis", "--root", ROOT, "--check-witness",
         DRMC_EDGES], 300)
    witness_drmc = {**_check_line(proc.stdout + proc.stderr, "witness"),
                    "returncode": proc.returncode}
    # 5. The multi-worker slice's plan.
    harness = MeshSliceHarness(n_workers=2, gpus_per_worker=4)
    try:
        plan = plan_from_worker_envs(harness.worker_envs())
    finally:
        harness.close()
    mesh = {"gpus": plan.n_devices, "workers": plan.n_workers,
            "contiguous": plan.contiguous, "hop_mean": plan.hop_mean,
            "modeled_nvlink_gbps": plan.modeled_nvlink_gbps}
    res = {"lint": lint, "drmc": drmc, "witness_chaos": witness_chaos,
           "witness_drmc": witness_drmc, "view_shadow": view,
           "mesh_slice": mesh,
           "check_s": chaos_check_s + drmc_check_s,
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": gpuinfo.nvidia_smi()}
    emit("analysis", **res)
    check(lint["returncode"] == 0 and lint["findings"] == 0
          and lint["unjustified"] == 0,
          f"analysis: dralint {lint['findings']} findings, "
          f"{lint['unjustified']} unjustified suppressions: "
          f"{doc['findings'][:5]}")
    check(lint_s < LINT_COLD_LIMIT_S,
          f"analysis: cold dralint took {lint_s:.1f} s")
    check(gate["distinct_total"] >= DRMC_MIN_SCHEDULES,
          f"analysis: drmc explored {gate['distinct_total']} schedules")
    check(all(c["points_run"] == c["points_enumerated"]
              >= DRMC_MIN_CRASH_POINTS for c in gate["crash"]),
          f"analysis: drmc crash points {drmc['crash_points']}")
    check(all(v >= DRMC_MIN_SCHEDULES for v in drmc["floors"].values()),
          f"analysis: drmc floors {drmc['floors']}")
    for name, rec in (("chaos", witness_chaos), ("drmc", witness_drmc)):
        check(rec["returncode"] == 0 and rec["unexplained"] == 0
              and rec["observed"] > 0,
              f"analysis: {name} witness edges against the static "
              f"graph: {rec}")
    check(walk.ok, f"analysis: view-shadow walk: {walk.violations[:5]}")
    check(view["unexplained"] == 0, f"analysis: view drifts: {view}")
    check(mesh["gpus"] == 8 and mesh["workers"] == 2 and mesh["contiguous"]
          and mesh["modeled_nvlink_gbps"] > 0,
          f"analysis: MeshSliceHarness(2, 4) plan: {mesh}")
    return res


def phase_race() -> dict:
    """The race tier on the card's host (host clock). The domain daemon's
    TSan flavour under tpu_dra_torch.race.tsan_drive: two daemons that
    list each other, idle clients, concurrent --check probes, reloads
    racing the sweep. drmc at hack/race.sh's deep budget without the
    crash matrix, exporting its witness's edges. Then, under the port's
    lock witness and view shadow (installed here, as the race tier's
    pytest plugin installs them for a session), the threaded paths the
    CPU tier's witnessed suites cover, through the port's own entry
    points: a two-node ComputeDomain (bench_cd_convergence: controller,
    two CD plugins, two native daemons), scheduler failover behind
    leader electors (bench_sched_failover) and the MPS and MIG prepares
    on a fake inventory (bench_fake_inventory_configs); and one hot
    restart of the plugin on NVML (bench_hot_restart), the threaded path
    only the card has. Those suites themselves hold the port against the
    reference, which the card's host does not run. Last, one
    --check-witness / --check-view-shadow over the phase's exports."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.infra import lockwitness
    from tpu_dra_torch.k8s import informer
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.race import runner, tsan_drive
    from tpu_dra_torch.workloads import _cuda

    t_phase = time.perf_counter()
    os.makedirs(RACE_DIR, exist_ok=True)
    for path in (RACE_EDGES, RACE_DRIFTS):
        if os.path.exists(path):
            os.unlink(path)
    tsan = tsan_drive.drive()
    drmc = runner.step_drmc(edges=RACE_EDGES, budget=RACE_DRMC_BUDGET)
    drives = {}
    lockwitness.install()
    shadow_prev = informer.SHADOW.enable()
    informer.SHADOW.reset()
    try:
        for name, fn in (
                ("cd_convergence", bench.bench_cd_convergence),
                ("sched_failover",
                 lambda: bench.bench_sched_failover(RACE_FAILOVERS)),
                ("fake_inventory", bench.bench_fake_inventory_configs)):
            t0 = time.perf_counter()
            try:
                rec = fn()
                errors = {k: v for k, v in rec.items()
                          if k.endswith("_error")}
                drives[name] = {"ok": not errors, "errors": errors}
            except Exception as e:  # noqa: BLE001  # drflow: swallow-ok[a failed drive is recorded and checked below]
                drives[name] = {"ok": False, "errors": repr(e)}
            drives[name]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        backend = gpuinfo.NativeBackend()
        try:
            hot = bench.bench_hot_restart(
                backend, duration_s=HOT_RESTART_S,
                workers=HOT_RESTART_WORKERS, gpus_per_worker=1,
                n_restarts=HOT_RESTARTS, scratch=_cuda.BUILD_DIR.parent)
        finally:
            backend.close()
        drives["hot_restart_nvml"] = {
            "ok": (hot["hot_restart_failed_rpcs"] == 0
                   and hot["hot_restart_leaked_claims"] == 0),
            "failed_rpcs": hot["hot_restart_failed_rpcs"],
            "leaked_claims": hot["hot_restart_leaked_claims"],
            "seconds": time.perf_counter() - t0}
        cycles = lockwitness.WITNESS.cycles()
        drifts = informer.SHADOW.violations_since(0)
        informer.SHADOW.export(RACE_DRIFTS)
        lockwitness.export_edges(RACE_EDGES)
    finally:
        informer.SHADOW.restore(shadow_prev)
        lockwitness.uninstall()
    checked = runner.step_check(RACE_EDGES, RACE_DRIFTS)
    passed = sorted(n for n, d in drives.items() if d["ok"])
    res = {"daemon_rcs": tsan["daemon_rcs"], "probes": tsan["probes"],
           "ready_probes": tsan["ready"], "peers_seen": tsan["peers_seen"],
           "tsan_reports": len(tsan["reports"]), "tsan_s": tsan["seconds"],
           "drmc": {"budget": RACE_DRMC_BUDGET, "distinct": drmc["distinct"],
                    "violations": drmc["violations"],
                    "seconds": drmc["seconds"]},
           "drives_passed": passed,
           "drives_failed": sorted(set(drives) - set(passed)),
           "drives": drives, "witness_cycles": cycles,
           "witness": checked["witness"],
           "view_shadow": checked["view_shadow"], "drifts": drifts,
           "check_s": checked["seconds"],
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": gpuinfo.nvidia_smi()}
    emit("race", **res)
    for report in tsan["reports"]:
        print(report, file=sys.stderr)
    check(tsan["ok"], f"race: TSan drive: {tsan['errors']}")
    check(drmc["ok"], f"race: drmc at {RACE_DRMC_BUDGET}: "
                      f"{drmc['violations'] or drmc.get('tail')}")
    check(not res["drives_failed"],
          f"race: witnessed drives failed: "
          f"{ {n: drives[n] for n in res['drives_failed']} }")
    check(not cycles, f"race: lock-order cycles: {cycles}")
    check(not drifts, f"race: view drifts: {drifts}")
    check(checked["ok"], f"race: observed within static: "
                         f"{checked['witness']} {checked['view_shadow']} "
                         f"{checked.get('tail', '')}")
    return res


def phase_scale() -> dict:
    """bench_sched_scale10k cut to SCALE_NODES x SCALE_PODS with
    SCALE_WATCHERS hollow watchers and a SCALE_BASELINE baseline: no full
    relist, no watcher overflow; the throughput ratio is read beside
    hack/perf.sh's gate, not checked."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.native import gpuinfo

    t_phase = time.perf_counter()
    rec = bench.bench_sched_scale10k(
        n_nodes=SCALE_NODES, n_pods=SCALE_PODS, n_watchers=SCALE_WATCHERS,
        baseline_nodes=SCALE_BASELINE[0], baseline_pods=SCALE_BASELINE[1])
    res = {"cut": f"{SCALE_NODES} nodes x {SCALE_PODS} pods, "
                  f"{SCALE_WATCHERS} watchers, baseline "
                  f"{SCALE_BASELINE[0]} x {SCALE_BASELINE[1]} "
                  "(reference default: 10000 x 100000, 100, "
                  "1000 x 5000)",
           **rec, "ratio_gate": SCALE_RATIO_GATE,
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": gpuinfo.nvidia_smi()}
    emit("scale", **res)
    check(rec["sched_scale10k_full_relists"] == 0,
          f"scale: {rec['sched_scale10k_full_relists']} full relists")
    check(rec["sched_scale10k_hollow_overflow_errors"] == 0,
          f"scale: {rec['sched_scale10k_hollow_overflow_errors']} "
          "watcher overflows")
    check("sched_scale10k_churn_gc_leak" not in rec,
          f"scale: {rec.get('sched_scale10k_churn_gc_leak')} claims leaked")
    return res


def claim_child(argv) -> int:
    """The claim child (claim_path, compute_domain, shared_claim, mps
    and mig):
    tpu_dra_torch.bench.claim_child on this process's environment, read
    as a claim's CDI env: plan_from_env -> devices_from_env ->
    launch_workload("train") at the flagship's full width, the launch
    counts zeroed just before the timed steps; where the env also holds a
    ComputeDomain channel claim's (NODE_RANK), the group starts at its
    MASTER_ADDR:MASTER_PORT; with --wait-go it takes
    its warm step and waits for the parent's "go" on stdin. Prints one
    JSON line: losses, step times, the host-clock window, the UUID of the
    device it ran on, the depth and steps, the launch counts and the
    allocator's peak."""
    from tpu_dra_torch import bench

    return bench.claim_child(argv)


def _shared_child_argv() -> list:
    return [sys.executable, os.path.join(ROOT, "chip_smoke.py"), CLAIM_CHILD]


def _check_tenant_launches(where: str, tenants) -> list:
    """check_path_launches on each tenant's counts (its timed steps)."""
    return [check_path_launches(f"{where} tenant {t['pid']}",
                                t["n_layers"] * t["steps"], t["launches"])
            for t in tenants]


def phase_shared_claim(backend, gpu) -> dict:
    """The gpu-test2 shape: one default-config claim of `gpu` prepared
    over the plugin's framed socket (bench_shared_claim), a solo claim
    child for bench.SHARED_STEPS steps, then two at once, their timed windows
    started together; each on the claim's UUID through the Hopper
    kernels. Returns bench_shared_claim's readings."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.workloads import _cuda

    res = bench.bench_shared_claim(
        backend, child_argv=_shared_child_argv(), gpu_index=gpu["index"],
        scratch=str(_cuda.BUILD_DIR.parent))
    solo = bench._tenant_reading(res["solo"])
    _check_tenant_launches("shared_claim solo", [solo])
    _check_tenant_launches("shared_claim", res["tenants"])
    emit("shared_claim", **bench.shared_claim_line(res),
         solo_max_memory_allocated=res["solo"]["max_memory_allocated"],
         gpu_memory_bytes=gpu["memory_bytes"],
         nvidia_smi=gpuinfo.nvidia_smi())
    return res


def _mps_processes() -> list:
    """Pids of the MPS control daemons and servers running here."""
    pids = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/comm") as f:
                if f.read().strip().startswith("nvidia-cuda-mps"):
                    pids.append(int(pid))
        except OSError:
            continue
    return pids


def phase_mps(backend, gpu, shared) -> dict:
    """shared_claim's two children on an MPS claim (the reference demo's
    50% active threads, a pinned memory limit of 1.5x the solo child's
    peak), the card's nvidia-cuda-mps-control run by an MpsNodeSim. One
    of three outcomes, each checked (bench_shared_claim): (a) the binary
    is not on PATH; (b) NVML refuses the compute mode and the prepare
    unwinds; (c) both children run as clients of the claim's daemon,
    which is gone after unprepare. The script is the children's
    container runtime: their env's mount paths are the host's."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.workloads import _cuda

    config = bench.mps_shared_config(shared["solo"]["max_memory_allocated"])
    res = bench.bench_shared_claim(
        backend, config=config, solo=shared["solo"],
        child_argv=_shared_child_argv(), gpu_index=gpu["index"],
        scratch=str(_cuda.BUILD_DIR.parent))
    line = bench.shared_claim_line(res)
    check(res["outcome"] in ("a", "b", "c"), f"mps outcome {res}")
    if res["ran"]:
        _check_tenant_launches("mps", res["tenants"])
        for t in res["tenants"]:
            check(t["mem_get_info"] is not None,
                  f"mps tenant {t['pid']} read no mem_get_info")
        emit("runtime_env", of="mps", rewritten=res["env_rewritten"],
             note="each mount's containerPath in the env replaced by its "
                  "hostPath, as a container runtime's bind would")
    else:
        left = _mps_processes()
        check(left == [], f"MPS processes {left} outlived outcome "
                          f"{res['outcome']}")
        line["mps_processes_after"] = left
    emit("mps", **line, nvidia_smi=gpuinfo.nvidia_smi())
    return res


def phase_mig(backend, gpu) -> dict:
    """Read-only unless the GPU is already in MIG mode: its MIG mode and,
    where NVML answers, its GPU-instance profiles and placements held
    against the H100 table FakeBackend serves (NVIDIA's MIG User Guide).
    In MIG mode, one 3g.40gb claim, a flagship child on its MIG- UUID,
    and an unprepare that leaves no instance. MIG mode is never changed
    here: that needs a GPU reset."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.workloads import _cuda

    g = backend.get_gpu(gpu["index"])
    profiles, error = [], None
    try:
        profiles = backend.mig_profiles(g.index)
    except gpuinfo.NvmlError as e:
        error = str(e)
    table = {name: starts
             for name, _, _, _, starts in gpuinfo.H100_MIG_PROFILES}
    mismatched = {p.name: list(p.starts) for p in profiles
                  if p.name in table and tuple(p.starts) != table[p.name]}
    res = {"mig_mode": g.mig_mode, "profiles": [
        {"name": p.name, "profile_id": p.profile_id,
         "memory_slices": p.memory_slices, "starts": list(p.starts)}
        for p in profiles], "profiles_error": error,
        "fake_table": {k: list(v) for k, v in table.items()},
        "mismatched": mismatched}
    check(not mismatched, f"NVML's MIG placements differ from the H100 "
                          f"table: {mismatched}")
    if not g.mig_mode:
        emit("mig", **res, claim=None,
             note="MIG mode is off; not enabled here (that needs a GPU "
                  "reset, which would take the card from every other "
                  "phase)")
        return res
    bd = bench._BenchDriver(backend, scratch=str(_cuda.BUILD_DIR.parent))
    try:
        name = next(n for n, d in bd.state.allocatable.items()
                    if d.gpu.index == g.index and d.mig is not None
                    and d.mig.profile == "3g.40gb")
        obj = bench._make_claim(bd.cluster, [], "mig-claim", devices=[name])
        entry = bd.prepare(obj)
        env, _ = bench.runtime_env(bd.cdi.container_edits(
            entry.devices[0].cdi_device_ids))
        mig_uuid = env["CUDA_VISIBLE_DEVICES"]
        check(mig_uuid.startswith("MIG-"), f"MIG claim env {mig_uuid}")
        (rec,), _ = bench._run_tenants(
            _shared_child_argv() + ["--steps", str(CLAIM_STEPS), "--warm",
                                    "1", "--wait-go"],
            {**os.environ, **env}, 1, ROOT)
        bench._check_tenants([rec], mig_uuid, "cuda")
        tenant = bench._tenant_reading(rec)
        _check_tenant_launches("mig", [tenant])
        bd.unprepare([obj])
        left = backend.mig_devices(g.index)
        check(left == [], f"MIG instances left after unprepare: {left}")
        res["claim"] = {"device": name, "uuid": mig_uuid, "tenant": tenant}
    finally:
        bd.release_prepared()
        bd.close()
    emit("mig", **res)
    return res


def phase_passthrough(gpu) -> dict:
    """Read-only: the GPU's PCI function in sysfs, its driver and IOMMU
    group (or their absence), whether the IOMMU is on and vfio_pci is
    loaded. Nothing is rebound: the run is on this GPU."""
    from tpu_dra_torch.gpuplugin.passthrough import PciSysfs, sysfs_address

    fs = PciSysfs("/")
    addr = sysfs_address(gpu["pci_bus_id"]) if gpu["pci_bus_id"] else None
    group = fs.iommu_group(addr) if addr else None
    res = {"pci_address": addr,
           "in_sysfs": bool(addr) and os.path.isdir(
               f"/sys/bus/pci/devices/{addr}"),
           "driver": fs.current_driver(addr) if addr else None,
           "iommu_group": group,
           "group_devices": fs.group_devices(group) if group else [],
           "iommu_enabled": fs.iommu_enabled(),
           "vfio_pci_loaded": fs.module_loaded("vfio_pci"),
           "rebound": False}
    emit("passthrough", **res)
    return res


def phase_device_sharing() -> dict:
    """shared_claim, mps, mig and passthrough, on the GPU torch calls
    cuda:0, before this process opens a CUDA context: under
    EXCLUSIVE_PROCESS the MPS server could not open its own beside one."""
    from tpu_dra_torch.native import gpuinfo

    backend = gpuinfo.NativeBackend()
    try:
        gpu = next(r for r in _nvml_inventory(backend) if r["cuda"] == 0)
        shared = phase_shared_claim(backend, gpu)
        mps = phase_mps(backend, gpu, shared)
        mig = phase_mig(backend, gpu)
        passthrough = phase_passthrough(gpu)
    finally:
        backend.close()
    return {"shared_claim": shared, "mps": mps, "mig": mig,
            "passthrough": passthrough}


def phase_main_path() -> tuple[dict, dict]:
    from tpu_dra_torch import bench
    from tpu_dra_torch.workloads import _cuda

    _cuda.reset_launches()
    res = bench.bench_mfu(steps=5)
    emit("main", launches=_cuda.launches(), **res)
    check(math.isfinite(res["loss"]), f"non-finite loss {res['loss']}")
    counts = check_path_launches("the main path",
                                 res["n_layers"] * res["step_calls"])
    loss = check_loss_launches("the main path", res["step_calls"])
    return {**res, "loss_launches": loss}, counts


def phase_long_context() -> tuple[dict, dict]:
    """bench_long_context at S=8192 and at S=16384, as bench.py's TPU
    phase calls it, each with the launch counts zeroed just before and
    read just after. Returns the S=16384 run's counts and its reading."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.workloads import _cuda

    counts = {}
    for steps, seq, prefix in ((4, LONG_S, "long_ctx"),
                               (3, XL_S, "long_ctx_xl")):
        _cuda.reset_launches()
        res = bench.bench_long_context(steps=steps, seq=seq, prefix=prefix)
        _free()
        emit("long_ctx", launches=_cuda.launches(), **res)
        check(math.isfinite(res["loss"]), f"non-finite {prefix} loss")
        counts = check_path_launches(prefix,
                                     res["n_layers"] * res["step_calls"])
        check_loss_launches(prefix, res["step_calls"])
    return counts, {**res, "kernel_launches": counts}


def phase_remat(xl_none: dict) -> dict:
    """long_ctx_xl (S=16384) at remat "dots" and "full", each with the
    launch counts zeroed just before and read just after: the backward
    n_layers x steps times and the forward twice that (each block's
    forward runs again in the backward). The "none" reading is
    long_ctx's own run at S=16384 (`xl_none`). Returns the three."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.workloads import _cuda

    out = {"none": xl_none}
    for remat in ("dots", "full"):
        _cuda.reset_launches()
        res = bench.bench_long_context(steps=3, seq=XL_S,
                                       prefix="long_ctx_xl", remat=remat)
        _free()
        counts = check_path_launches(
            f"long_ctx_xl remat={remat}", res["n_layers"] * res["step_calls"],
            forward_runs=res["forward_runs"])
        check_loss_launches(f"long_ctx_xl remat={remat}", res["step_calls"])
        check(math.isfinite(res["loss"]), f"non-finite remat={remat} loss")
        out[remat] = {**res, "kernel_launches": counts}
    emit("remat", seq=XL_S, readings={
        remat: {"step_s": r["long_ctx_xl_step_s"],
                "tokens_per_s": r["long_ctx_xl_tokens_per_s"],
                "peak_memory_bytes": r["peak_memory_bytes"],
                "forward_runs": r["forward_runs"],
                "kernel_launches": r["kernel_launches"],
                "step_calls": r["step_calls"], "loss": r["loss"]}
        for remat, r in out.items()})
    return out


def phase_moe() -> dict:
    """bench.bench_moe: the MoE LM at the flagship's widths on the card,
    launch counts zeroed just before and read just after (every block's
    attention through the Hopper kernels; every MoE block's route,
    dispatch and combine through the MoE kernels, MOE_BLOCK_LAUNCHES
    ["top1"] per step call)."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads import _moe_kernels as mk

    _cuda.reset_launches()
    res = bench.bench_moe(steps=3)
    _free()
    counts = check_path_launches("moe", res["n_layers"] * res["step_calls"])
    check_loss_launches("moe", res["step_calls"])
    moe_counts = kernel_launches(mk.ARGTYPES)
    per_block = res["moe_blocks"] * res["step_calls"]
    want = {name: n * per_block
            for name, n in MOE_BLOCK_LAUNCHES["top1"].items()}
    check(moe_counts == want, f"moe kernel launches {moe_counts}, want {want}")
    emit("moe", kernel_launches=counts, moe_kernel_launches=moe_counts, **res)
    return {**res, "moe_kernel_launches": moe_counts}


def phase_dsv3() -> dict:
    """A bf16 train step of the DeepSeek-V3 family (DSV3_STEP: Moonlight's
    widths, one dense and two MoE blocks) on the card, launch counts
    zeroed just before DSV3_STEPS step calls and read just after: every
    block's attention through the Hopper kernels (the wrappers' sm90
    route, never the mma one), every MoE block's route, dispatch and
    combine through the top-k kernels, MOE_BLOCK_LAUNCHES["topk"] per
    step call, none through the top-1 layer's route. Returns
    {"attention": {"DqkxDv": {kernel: launches}}, "moe": {kernel:
    launches}, "losses": [...]}."""
    import torch

    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads import _flash_kernels as fk
    from tpu_dra_torch.workloads import _moe_kernels as mk
    from tpu_dra_torch.workloads import dsv3_model as dm

    cfg = dm.DSV3Config(**DSV3_STEP)
    gen = torch.Generator(device="cuda").manual_seed(22)
    step = dm.make_train_step(dm.DSV3LM(cfg, dm.init_params(cfg, gen)))
    tokens = torch.randint(0, cfg.vocab, (DSV3_BATCH, cfg.max_seq + 1),
                           generator=gen, device="cuda")
    step(tokens)   # the first call builds the kernels
    torch.cuda.synchronize()
    _cuda.reset_launches()
    losses = [step(tokens).item() for _ in range(DSV3_STEPS)]
    torch.cuda.synchronize()
    calls = cfg.n_layers * DSV3_STEPS
    blocks = (cfg.n_layers - cfg.first_dense) * DSV3_STEPS
    attention = kernel_launches(fk.ARGTYPES)
    want = {name: calls if name in (fk.FWD_KERNELS["sm90"],
                                    fk.BWD_KERNELS["sm90"]) else 0
            for name in fk.ARGTYPES}
    check(attention == want,
          f"dsv3 attention launches {attention}, want {want}")
    moe_counts = kernel_launches(mk.ARGTYPES)
    want = {name: n * blocks
            for name, n in MOE_BLOCK_LAUNCHES["topk"].items()}
    check(moe_counts == want,
          f"dsv3 moe kernel launches {moe_counts}, want {want}")
    check_loss_launches("dsv3", DSV3_STEPS)
    check(all(math.isfinite(x) for x in losses), f"dsv3 losses {losses}")
    dims = f"{cfg.qk_nope_dim + cfg.qk_rope_dim}x{cfg.v_head_dim}"
    res = {"attention": {dims: attention}, "moe": moe_counts,
           "losses": losses}
    emit("dsv3", n_layers=cfg.n_layers, moe_blocks=cfg.n_layers
         - cfg.first_dense, step_calls=DSV3_STEPS, batch=DSV3_BATCH,
         seq=cfg.max_seq, **res)
    del step
    _free()
    return res


def phase_mimo() -> dict:
    """A bf16 train step of the MiMo-V2-Flash family (MIMO_STEP: its
    published widths and the cell's seven layers) on the card, launch
    counts zeroed just before one step call and read just after, under a
    host-only profiler session so the step's own counters and ranges
    record: every attention call through the Hopper kernels (none through
    the mma ones), one forward and one backward per layer, the window
    calls those under the range attention.window (one per window layer);
    attention.window_tiles the band's tile count (fwd_tiles) per window
    call, not the causal triangle's; attention.dkv_reduce_ctas the split
    global calls' K tiles x B x Hq (0 from the window calls); every MoE
    block's routing through the top-k kernels. Returns {"global" |
    "window": {kernel: launches a step}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_dra_torch.infra import trace
    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads import _flash_kernels as fk
    from tpu_dra_torch.workloads import _moe_kernels as mk
    from tpu_dra_torch.workloads import mimo_model as mm

    cfg = mm.MiMoConfig(**MIMO_STEP)
    gen = torch.Generator(device="cuda").manual_seed(26)
    params = mm.init_params(cfg, gen)
    sinks = [blk["attn"]["sinks"].clone() for blk in params["blocks"]
             if "sinks" in blk["attn"]]
    step = mm.make_train_step(mm.MiMoLM(cfg, params))
    tokens = torch.randint(0, cfg.vocab, (1, cfg.max_seq + 1),
                           generator=gen, device="cuda")
    step(tokens)   # the first call builds the kernels
    torch.cuda.synchronize()
    trace.read_counters()
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = step(tokens).item()
        torch.cuda.synchronize()
    counts = trace.read_counters()
    attention = kernel_launches(fk.ARGTYPES)
    n_window = sum(cfg.hybrid_pattern)
    want = {name: cfg.n_layers if name in (fk.FWD_KERNELS["sm90"],
                                           fk.BWD_KERNELS["sm90"]) else 0
            for name in fk.ARGTYPES}
    check(attention == want,
          f"mimo attention launches {attention}, want {want}")
    ranges = sum(e.count for e in prof.key_averages()
                 if e.key == "attention.window")
    check(ranges == n_window,
          f"mimo attention.window ranges {ranges}, want {n_window}")
    s = cfg.max_seq
    tiles = n_window * cfg.n_heads * fk.fwd_tiles(s, cfg.window)
    pairs = n_window * cfg.n_heads * fk.band_pairs(s, cfg.window)
    check(counts.get("attention.window_tiles") == tiles
          and tiles < n_window * cfg.n_heads * fk.fwd_tiles(s, 0),
          f"mimo attention.window_tiles {counts.get('attention.window_tiles')}"
          f", want the band's {tiles}")
    check(counts.get("attention.window_pairs") == pairs,
          f"mimo attention.window_pairs {counts.get('attention.window_pairs')}"
          f", want {pairs}")
    n_global = cfg.n_layers - n_window
    ctas = n_global * -(-s // fk.SM90_BWD_KEYS) * cfg.n_heads
    check(counts.get("attention.dkv_reduce_ctas") == ctas,
          f"mimo attention.dkv_reduce_ctas "
          f"{counts.get('attention.dkv_reduce_ctas')}, want {ctas}")
    moe_counts = kernel_launches(mk.ARGTYPES)
    blocks = cfg.n_layers - cfg.first_dense
    want = {name: n * blocks
            for name, n in MOE_BLOCK_LAUNCHES["topk"].items()}
    check(moe_counts == want,
          f"mimo moe kernel launches {moe_counts}, want {want}")
    check_loss_launches("mimo", 1)
    check(math.isfinite(loss), f"mimo loss {loss}")
    moved = [not torch.equal(blk["attn"]["sinks"], before) for blk, before
             in zip((b for b in params["blocks"] if "sinks" in b["attn"]),
                    sinks)]
    check(all(moved), f"mimo sinks moved by the step: {moved}")
    # Each layer's call launches one forward and one backward: the window
    # layers' are those under attention.window, the rest the global ones.
    per_kind = {"window": ranges, "global": cfg.n_layers - ranges}
    res = {kind: {name: n // cfg.n_layers * calls
                  for name, n in attention.items()}
           for kind, calls in per_kind.items()}
    emit("mimo", n_layers=cfg.n_layers, pattern=list(cfg.hybrid_pattern),
         seq=s, loss=loss, launches=attention, window_ranges=ranges,
         window_tiles=counts["attention.window_tiles"],
         causal_tiles=n_window * cfg.n_heads * fk.fwd_tiles(s, 0),
         window_pairs=counts["attention.window_pairs"],
         dkv_reduce_ctas=counts["attention.dkv_reduce_ctas"], moe=moe_counts,
         per_kind=res)
    del step, params
    _free()
    return res


def phase_kimi() -> dict:
    """A bf16 train step of the Kimi Linear family (KIMI_CONFIG: its
    published widths and the cell's eight layers, KDA x 3 then MLA,
    twice; 8 of 256 experts held, top-8) at KIMI_STEP_S and KIMI_STEP's
    vocabulary on the card, the launch counts zeroed just before the
    step's loss alone (no gradient) and again just before one step call,
    the step under a host-only profiler session so its own counters and
    ranges record. Checked: every KDA layer's chunk op through the
    KDA kernels, KDA_CALL_LAUNCHES a call each way, and its short convs
    and gated norm through the mixer kernels, MIXER_LAYER_LAUNCHES a
    layer; one range attention.kda per KDA layer, attention.kda_tokens B
    x S and attention.kda_chunks B x H x ceil(S / 64) per KDA layer;
    every MLA layer's attention through the Hopper kernels, one forward
    and one backward a layer, none through the mma ones; every MoE
    block's routing through the top-k kernels; the loss head's kernels
    once; a_log, the decays' scale, moved by the step. Returns
    {"kda_fwd" | "kda_bwd": {kernel: launches a step}, "mixer": {kernel:
    launches a step}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.models.kimi_lm import model_config
    from tpu_dra_torch.infra import trace
    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads import _flash_kernels as fk
    from tpu_dra_torch.workloads import _kda_kernels as kk
    from tpu_dra_torch.workloads import _mixer_kernels as mx
    from tpu_dra_torch.workloads import _moe_kernels as mk
    from tpu_dra_torch.workloads import kimi_model as km

    with open(os.path.join(ROOT, KIMI_CONFIG)) as f:
        keys = dict(json.load(f), **KIMI_STEP)
    cfg = model_config(keys, KIMI_STEP_S)
    gen = torch.Generator(device="cuda").manual_seed(28)
    params = km.init_params(cfg, gen)
    a_log = [blk["attn"]["a_log"].clone() for blk in params["blocks"]
             if "a_log" in blk["attn"]]
    model = km.KimiLM(cfg, params)
    step = km.make_train_step(model)
    b, s = 1, cfg.max_seq
    tokens = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                           device="cuda")
    step(tokens)   # the first call builds the kernels
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with torch.no_grad():
        km.loss_fn(model, tokens).item()
    fwd = kernel_launches(kk.ARGTYPES)
    fwd_mixer = kernel_launches(mx.ARGTYPES)
    trace.read_counters()
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = step(tokens).item()
        torch.cuda.synchronize()
    counts = trace.read_counters()
    n_kda = sum(cfg.kda_pattern)
    n_mla = cfg.n_layers - n_kda
    total = kernel_launches(kk.ARGTYPES)
    kda = {"kda_fwd": fwd,
           "kda_bwd": {n: total[n] - fwd[n] for n in kk.ARGTYPES}}
    for name, got in kda.items():
        want = {n: n_kda * KDA_CALL_LAUNCHES[name].get(n, 0)
                for n in kk.ARGTYPES}
        check(got == want, f"kimi {name} launches a step {got}, want {want}")
    mixer = kernel_launches(mx.ARGTYPES)
    want = {n: n_kda * c for n, c in MIXER_LAYER_LAUNCHES.items()}
    check(mixer == want, f"kimi mixer launches a step {mixer}, want {want}")
    want = {n: c if n.endswith("_fwd") else 0 for n, c in want.items()}
    check(fwd_mixer == want,
          f"kimi mixer launches in the forward {fwd_mixer}, want {want}")
    attention = kernel_launches(fk.ARGTYPES)
    want = {name: n_mla if name in (fk.FWD_KERNELS["sm90"],
                                    fk.BWD_KERNELS["sm90"]) else 0
            for name in fk.ARGTYPES}
    check(attention == want,
          f"kimi attention launches {attention}, want {want}")
    ranges = sum(e.count for e in prof.key_averages()
                 if e.key == "attention.kda")
    check(ranges == n_kda, f"kimi attention.kda ranges {ranges}, "
                           f"want {n_kda}")
    want = {"attention.kda_tokens": n_kda * b * s,
            "attention.kda_chunks": n_kda * b * cfg.kda_heads
            * kk.n_chunks(s)}
    got = {n: counts.get(n) for n in want}
    check(got == want, f"kimi counters {got}, want {want}")
    moe_counts = kernel_launches(mk.ARGTYPES)
    blocks = cfg.n_layers - cfg.first_dense
    want = {name: n * blocks
            for name, n in MOE_BLOCK_LAUNCHES["topk"].items()}
    check(moe_counts == want,
          f"kimi moe kernel launches {moe_counts}, want {want}")
    check_loss_launches("kimi", 1)
    check(math.isfinite(loss), f"kimi loss {loss}")
    moved = [not torch.equal(blk["attn"]["a_log"], before) for blk, before
             in zip((x for x in params["blocks"] if "a_log" in x["attn"]),
                    a_log)]
    check(all(moved), f"kimi a_log moved by the step: {moved}")
    res = {**kda, "mixer": mixer}
    emit("kimi", n_layers=cfg.n_layers, pattern=list(cfg.kda_pattern),
         seq=s, loss=loss, attention=attention, kda_ranges=ranges,
         **got, moe=moe_counts, launches=res)
    del step, model, params
    _free()
    return res


def phase_ring_local() -> dict:
    """An N=RING_N ring emulated in one process at long_ctx_xl's attention
    shape (B1 S16384 H16 D128 bf16, rope off): each rank's steps in turn
    through the distributed ring's own step_partial and merge, forward
    and backward, launch counts zeroed just before and read just after
    (the diagonal blocks causal, the past ones non-causal, all with the
    merge's nonzero dlse); held against one causal
    flash_attention_with_lse over the whole S, out, dq, dk and dv within
    TOL_REL; both timed (CUDA events, forward + backward)."""
    import torch

    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads import _flash_kernels as fk
    from tpu_dra_torch.workloads.flashattention import (
        flash_attention_with_lse,
    )
    from tpu_dra_torch.workloads.ringattention import (
        DIAGONAL, FUTURE, PAST, ring_attention_local,
    )

    b, h, d = XL_ATTN["b"], XL_ATTN["h"], XL_ATTN["d"]
    q, k, v, dout, _ = _inputs(b, XL_S, h, d, seed=500)
    q, k, v = (x.detach().contiguous().requires_grad_() for x in (q, k, v))
    cases: dict = {}
    _cuda.reset_launches()
    out = ring_attention_local(q, k, v, RING_N, causal=True, impl="flash",
                               partial_counts=cases)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    counts = kernel_launches(fk.ARGTYPES)
    steps = cases.get(DIAGONAL, 0) + cases.get(PAST, 0)
    want = {name: steps if name in MODEL_PATH_KERNELS else 0
            for name in counts}
    check(counts == want, f"ring launches {counts}, want {want}")
    ref, _ = flash_attention_with_lse(q, k, v, causal=True)
    ref_grads = torch.autograd.grad(ref, (q, k, v), dout)
    diffs = {}
    for name, got, want_t in zip(("out", "dq", "dk", "dv"),
                                 (out, *grads), (ref, *ref_grads)):
        diff = Diff()
        diff.add(got.detach(), want_t.detach())
        diffs[name] = diff
    finite = all(bool(torch.isfinite(x).all()) for x in (out, *grads))

    def run(fn):
        def call():
            o = fn()
            torch.autograd.grad(o, (q, k, v), dout)
        return call

    ring_ms = time_ms(run(lambda: ring_attention_local(
        q, k, v, RING_N, causal=True, impl="flash")), reps=3, inner=1)
    full_ms = time_ms(run(lambda: flash_attention_with_lse(
        q, k, v, causal=True)[0]), reps=3, inner=1)
    res = {"n": RING_N, "shape": dict(b=b, s=XL_S, h=h, d=d,
                                      s_local=XL_S // RING_N),
           "steps_by_case": {"future": cases.get(FUTURE, 0),
                             "diagonal": cases.get(DIAGONAL, 0),
                             "past": cases.get(PAST, 0)},
           "kernel_launches": counts, "finite": finite,
           **{f"{n}_rel": dd.rel for n, dd in diffs.items()},
           **{f"{n}_abs": dd.abs for n, dd in diffs.items()},
           "tol_rel": TOL_REL, "ring_fwd_bwd_ms": ring_ms,
           "unsharded_fwd_bwd_ms": full_ms}
    emit("ring_local", **res)
    check(finite, "non-finite ring output or gradient")
    for name, dd in diffs.items():
        check(dd.rel <= TOL_REL, f"ring {name} rel {dd.rel} > {TOL_REL}")
    del q, k, v, dout, out, grads, ref, ref_grads
    _free()
    return res


def phase_mesh_workloads() -> dict:
    """Every registered workload through meshbuild.launch_workload on the
    plan of a claim of this node's GPUs (its NVML inventory's env), each
    starting its own world-1 NCCL group (a failed start raises), launch
    counts zeroed just before each: "train" the flagship as the DP x TP
    step at a (1, 1) grid, n_layers x steps launches of flash_fwd_sm90
    and flash_bwd_sm90 over its timed steps; then bench_psum over the
    same env: 0.0 with its skip_reason on one GPU, and the local
    memory-bandwidth proxy against the card's rate."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.topology.meshexport import plan_from_env
    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads import _flash_kernels as fk
    from tpu_dra_torch.workloads import _moe_kernels as mk
    from tpu_dra_torch.workloads import meshbuild

    backend = gpuinfo.NativeBackend()
    try:
        env = bench.node_env(backend)
    finally:
        backend.close()
    plan = plan_from_env(env)
    devices = meshbuild.devices_from_env(env, "cuda")
    records = {}
    for name, kw in meshbuild.default_runs(
            {}, {"steps": MESH_TRAIN_STEPS, "warm_steps": 1,
                 "barrier": _cuda.reset_launches}):
        _cuda.reset_launches()
        rec = meshbuild.launch_workload(name, plan, devices, **kw)
        _free()
        rec = {k: v for k, v in rec.items() if k != "window"}
        rec["kernel_launches"] = kernel_launches(fk.ARGTYPES)
        rec["moe_kernel_launches"] = kernel_launches(mk.ARGTYPES)
        emit("mesh_workload", name=name, plan_devices=plan.n_devices, **rec)
        records[name] = rec
    train = records["train"]
    check(all(math.isfinite(x) for x in train["losses"]),
          f"non-finite mesh train loss {train['losses']}")
    check(train["grid"] == [1, 1], f"train grid {train['grid']}")
    check_path_launches("mesh_workloads train",
                        train["n_layers"] * train["steps"],
                        train["kernel_launches"])
    for name in ("ringattention", "ulysses", "sp_train"):
        check(sum(records[name]["kernel_launches"].values()) > 0,
              f"{name} launched no kernel on the card")
    check(not any(train["moe_kernel_launches"].values()),
          f"the flagship train launched {train['moe_kernel_launches']}")
    # The expert-parallel FFN's forward: per call the route, the dispatch
    # (a gather) and the combine (a k-way sum at k = 1).
    ep = records["moe"]["moe_kernel_launches"]
    n = ep["moe_route"]
    check(n > 0 and ep == {**dict.fromkeys(ep, 0), "moe_route": n,
                           "moe_gather_rows": n, "moe_combine_rows": n},
          f"mesh moe launched {ep}")
    # sp_train's fp32 D16 model: its backward is the mma.sync route's.
    sp = records["sp_train"]["kernel_launches"]
    check(sp["flash_bwd_mma"] > 0 and sp["flash_bwd_sm90"] == 0,
          f"sp_train's fp32 backward launched {sp}")
    psum = bench.bench_psum(env)
    peak_bytes = gpuinfo.PEAK_HBM_BYTES_PER_S[H100_SXM]
    proxy = psum.get("local_hbm_proxy_gbps")
    emit("psum", **psum, card_hbm_gbps=peak_bytes / 1e9,
         hbm_proxy_share=None if proxy is None else proxy * 1e9 / peak_bytes,
         nvidia_smi=gpuinfo.nvidia_smi())
    if plan.n_devices == 1:
        check(psum["algo_gbps"] == 0.0 and psum["bus_gbps"] == 0.0
              and psum.get("skip_reason"),
              f"one-GPU psum record {psum}")
        check(psum["local_hbm_proxy_gbps"] > 0,
              f"no memory-bandwidth proxy: {psum}")
    return {"records": records, "psum": psum,
            "median_train_step_s": statistics.median(
                train["step_times_s"])}


@contextlib.contextmanager
def plain_kernels():
    """The flash path with each kernel wrapper swapped for its plain
    version (the same rounding points), restored on exit."""
    from tpu_dra_torch.workloads import _flash_kernels as fk

    saved = fk.fwd, fk.bwd
    fk.fwd, fk.bwd = fk.fwd_plain, fk.bwd_plain
    try:
        yield
    finally:
        fk.fwd, fk.bwd = saved


def _model_run(base, params, tokens, impl):
    """(logits, loss, grads, leaf names) of a fresh model on a copy of
    `params`."""
    import torch

    from tpu_dra_torch.workloads.model import (
        ModelConfig, TransformerLM, loss_fn,
    )

    model = TransformerLM(ModelConfig(**base, attn_impl=impl), {
        "embed": params["embed"].clone(),
        "unembed": params["unembed"].clone(),
        "blocks": [{n: t.clone() for n, t in bp.items()}
                   for bp in params["blocks"]]})
    logits = model(tokens[:, :-1]).detach()
    loss = loss_fn(model, tokens)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return (logits, float(loss.detach()), grads,
            [n for n, _ in model.named_parameters()])


def phase_model_parity(seeds=(1, 2)) -> dict:
    """The kernel path against two plain paths, per seed: "plain" is the
    same flash path with every kernel swapped for its plain version (the
    same rounding points, so only summation order differs); "reference"
    is plain attention with bf16 scores, as the reference model's own
    parity test compares. Both within the reference's bf16 bounds."""
    import torch

    from tpu_dra_torch.workloads.model import ModelConfig, init_params

    base = dict(vocab=1024, d_model=512, n_heads=4, n_layers=2, d_ff=1024,
                max_seq=256)
    out = {}
    for seed in seeds:
        params = init_params(ModelConfig(**base),
                             torch.Generator().manual_seed(seed), "cuda")
        tokens = torch.randint(
            0, base["vocab"], (2, base["max_seq"]),
            generator=torch.Generator().manual_seed(seed + 1000)).cuda()
        lk, loss_k, gk, names = _model_run(base, params, tokens, "auto")
        check(math.isfinite(loss_k) and bool(torch.isfinite(lk).all()),
              "non-finite kernel-path logits or loss")
        with plain_kernels():
            plain = _model_run(base, params, tokens, "flash")
        ref = _model_run(base, params, tokens, "reference")
        for against, (lr, loss_r, gr, _) in (("plain", plain),
                                             ("reference", ref)):
            logits_rel = float((lk - lr).norm() / lr.norm())
            grad_rel = {n: _max_rel(a, b) for n, a, b in zip(names, gk, gr)}
            worst = max(grad_rel, key=grad_rel.get)
            res = dict(seed=seed, against=against, logits_rel=logits_rel,
                       loss_kernel=loss_k, loss_against=loss_r,
                       worst_grad=worst, worst_grad_rel=grad_rel[worst])
            emit("parity", config=base, **res, grad_rel=grad_rel)
            check(logits_rel <= TOL_LOGITS, f"logits rel {res}")
            check(grad_rel[worst] <= TOL_GRAD, f"grad rel {res}")
            out[(seed, against)] = res
    return out


def phase_model_parity_fp32(seed=3) -> dict:
    """An fp32 model at S=8192 on the card: the kernel path (the fp32
    kernels, counted) against the same path on the kernels' plain
    versions, whose only difference is summation order."""
    import torch

    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads import _flash_kernels as fk
    from tpu_dra_torch.workloads.model import ModelConfig, init_params

    base = dict(vocab=1024, d_model=512, n_heads=4, n_layers=2, d_ff=1024,
                max_seq=FP32_LONG_S, dtype=torch.float32)
    params = init_params(ModelConfig(**base),
                         torch.Generator().manual_seed(seed), "cuda")
    tokens = torch.randint(
        0, base["vocab"], (1, base["max_seq"]),
        generator=torch.Generator().manual_seed(seed + 1000)).cuda()
    _cuda.reset_launches()
    lk, loss_k, gk, names = _model_run(base, params, tokens, "auto")
    counts = kernel_launches(fk.ARGTYPES)
    check(math.isfinite(loss_k) and bool(torch.isfinite(lk).all()),
          "non-finite fp32 kernel-path logits or loss")
    # Two forwards (logits, loss), through the mma.sync forward, and one
    # backward per layer, through the mma.sync route's fused backward.
    want = {"flash_fwd_sm90": 0, "flash_fwd": 2 * base["n_layers"],
            "flash_bwd_sm90": 0, "flash_bwd_mma": base["n_layers"]}
    check(counts == want, f"fp32 model launches {counts}, want {want}")
    with plain_kernels():
        lr, loss_r, gr, _ = _model_run(base, params, tokens, "flash")
    logits_rel = float((lk - lr).norm() / lr.norm())
    grad_rel = {n: _max_rel(a, b) for n, a, b in zip(names, gk, gr)}
    worst = max(grad_rel, key=grad_rel.get)
    res = dict(seed=seed, against="plain", logits_rel=logits_rel,
               loss_kernel=loss_k, loss_against=loss_r, worst_grad=worst,
               worst_grad_rel=grad_rel[worst], launches=counts)
    emit("parity_fp32", config={**base, "dtype": "float32"}, **res,
         grad_rel=grad_rel)
    check(logits_rel <= TOL_LOGITS_FP32, f"fp32 logits rel {res}")
    check(grad_rel[worst] <= TOL_GRAD_FP32, f"fp32 grad rel {res}")
    del lk, gk, lr, gr, params
    _free()
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tpu_dra_torch.native import gpuinfo

    # Plain versions and the parity reference compute in full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    info = phase_probe()
    phase_build()
    phase_device_sharing()
    flagship = phase_kernels()
    fp32_case = phase_kernels_fp32()
    long_bf16 = phase_kernels_long()
    mla_checks = phase_kernels_mla()
    # Bounds are against the H100 SXM's published peaks (700 W). fp32
    # runs three TF32 products per product: a third of the TF32 peak.
    peak_bf16 = gpuinfo.PEAK_BF16_TFLOPS[H100_SXM] * 1e12
    peak_bytes = gpuinfo.PEAK_HBM_BYTES_PER_S[H100_SXM]
    times = phase_times(peak_bf16, peak_bytes)
    times_xl = phase_times_xl(peak_bf16, peak_bytes)
    times_fp32 = phase_times_fp32(
        gpuinfo.PEAK_TF32_TFLOPS[H100_SXM] * 1e12 / 3, peak_bytes)
    mla_times = phase_times_mla(peak_bf16, peak_bytes)
    _free()
    mimo_times = phase_mimo_attention(peak_bf16, peak_bytes)
    _free()
    kda_times = phase_kimi_kda(peak_bf16, peak_bytes)
    _free()
    mixer_times = phase_kimi_mixer(peak_bytes)
    _free()
    moe_times = phase_moe_kernels(peak_bytes)
    _free()
    loss_times = phase_loss_head(peak_bytes)
    claim = phase_claim_path()
    phase_compute_domain()
    phase_cluster(claim["claim_path"]["child"])
    phase_e2e()
    phase_hot_restart()
    phase_ops()
    phase_chaos()
    phase_analysis()
    phase_race()
    phase_scale()
    main_res, counts = phase_main_path()
    _free()
    counts_xl, xl_none = phase_long_context()
    phase_remat(xl_none)
    moe_res = phase_moe()
    dsv3_res = phase_dsv3()
    mimo_res = phase_mimo()
    kimi_res = phase_kimi()
    phase_ring_local()
    phase_mesh_workloads()
    phase_model_parity()
    parity_fp32 = phase_model_parity_fp32()

    def max_err(res):
        return {"flash_fwd": res["out_abs"], "flash_bwd_dq": res["dq_abs"],
                "flash_bwd_dkv": max(res["dk_abs"], res["dv_abs"])}

    tiers = {  # entry suffix -> (times, launches, max_abs_err)
        "": (times, counts, max_err(flagship)),
        "_xl": (times_xl, counts_xl, max_err(long_bf16)),
        "_fp32": (times_fp32, parity_fp32["launches"], max_err(fp32_case)),
    }
    kernels = []
    for entry, wrapper, kname, replaces in TPU_KERNELS:
        suffix = next(x for x in ("_xl", "_fp32", "") if entry.endswith(x))
        base = entry[:len(entry) - len(suffix)]
        t_all, cnt, err = tiers[suffix]
        t = t_all[wrapper]
        kernels.append({
            "name": entry, "route": "cuda", "source": SOURCES[kname],
            "replaces": replaces, "launches": cnt[kname],
            "max_abs_err": err[base], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    kernels += moe_kernel_rows(moe_times, {
        "top1": moe_res["moe_kernel_launches"], "topk": dsv3_res["moe"]})
    kernels += mla_kernel_rows(mla_checks, mla_times, dsv3_res["attention"])
    kernels += mimo_kernel_rows(mimo_times, mimo_res)
    kernels += kda_kernel_rows(kda_times, kimi_res)
    kernels += mixer_kernel_rows(mixer_times, kimi_res["mixer"])
    kernels += loss_kernel_rows(loss_times, {
        name: n // main_res["step_calls"]
        for name, n in main_res["loss_launches"].items()})
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(info["nvidia_smi"] or f"{info['name']}, power limit not reported")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [CLAIM_CHILD]:
        sys.path.insert(0, ROOT)
        sys.exit(claim_child(sys.argv[2:]))
    sys.exit(main())
