"""The TPU probes on the card, and every TPU kernel's counterpart.

The JAX package's ``scripts/probes/`` holds five scripts whose Pallas
kernels asked the TPU questions about its passes: what a plain stream of
the state reaches (``profile_dma``), what each pass flavour costs, offset
windows included (``kernel_microbench``), what the window pass costs in
other formulations (``probe_kernel_variants``), what rank and the lower
matmul precisions cost (``profile_rank_kernels``) and what a fused direct
Pauli rotation costs against the gather form (``probe_flip_pallas``).
Each module here, named after its script, asks the same question on an
NVIDIA card:

* ``check(device, n)``: the probe's correctness part at n qubits, on the
  card through the kernels, on the CPU through their plain versions;
* ``run(device="cuda")``: the probe's timings at the script's sizes
  (CUDA-event medians over chained launches); it refuses any device but
  a CUDA card, so no time is ever taken on the CPU;
* ``main()``, for ``python -m quest_tpu_torch.probes.<name>``: JSON
  lines, the first the card's name and power limit.

The probe at profile_dma.py:52 streams the state, which no kernel of the
port computed: ``ops/stream.py`` and ``csrc/probes.cu`` add it (P1).  The
other seven sites compute functions the port's K1 and K3 already compute
(the 256 x 256 real representations, bf16 splits, permutation matmuls
and block shapes in them are TPU tiling), so each one's counterpart is
that kernel driven at the probe's shapes.

``COUNTERPARTS`` maps every ``pallas_call`` site of the repository, as
"path:line" of the call, to (label, port source, kernel, port entry):
the twelve of the JAX package's ``ops`` and the eight of the probes.
"""

COUNTERPARTS = {
    "quest_tpu/ops/fused.py:497": (
        "K1", "quest_tpu_torch/csrc/window.cu", "window_pass_kernel",
        "quest_tpu_torch.ops.fused.apply_window_stack"),
    "quest_tpu/ops/fused.py:799": (
        "K2", "quest_tpu_torch/csrc/window.cu", "megawin_kernel",
        "quest_tpu_torch.ops.fused.apply_window_megastack"),
    "quest_tpu/ops/paulis.py:625": (
        "K3", "quest_tpu_torch/csrc/paulis.cu", "pauli_rotation_kernel",
        "quest_tpu_torch.ops.paulis.direct_rotation"),
    "quest_tpu/ops/paulis.py:602": (
        "K4", "quest_tpu_torch/csrc/paulis.cu", "pauli_expec_kernel",
        "quest_tpu_torch.ops.paulis.expec_term"),
    "quest_tpu/ops/fused.py:1440": (
        "K5", "quest_tpu_torch/csrc/channels.cu", "chan_sweep_kernel",
        "quest_tpu_torch.ops.fused.apply_pair_channel_sweep"),
    "quest_tpu/ops/fused.py:887": (
        "K6", "quest_tpu_torch/csrc/qft.cu", "qft_hi_kernel",
        "quest_tpu_torch.ops.fused.apply_qft_ladder_pallas"),
    "quest_tpu/ops/fused.py:1003": (
        "K7", "quest_tpu_torch/csrc/qft.cu", "qft_sublane_kernel",
        "quest_tpu_torch.ops.fused.apply_qft_ladder_pallas"),
    "quest_tpu/ops/fused.py:1127": (
        "K8", "quest_tpu_torch/csrc/qft.cu", "qft_hi_kernel",
        "quest_tpu_torch.ops.fused.apply_qft_multi_hi"),
    "quest_tpu/ops/fused.py:1228": (
        "K9", "quest_tpu_torch/csrc/qft.cu", "qft_sublane_kernel",
        "quest_tpu_torch.ops.fused.apply_qft_cluster_multi"),
    "quest_tpu/ops/bigstate.py:108": (
        "K10", "quest_tpu_torch/csrc/qft.cu", "sigma_swap_kernel",
        "quest_tpu_torch.ops.bigstate.apply_sigma_swap"),
    "quest_tpu/ops/fused.py:543": (
        "K11", "quest_tpu_torch/csrc/window.cu", "window_pass_kernel",
        "quest_tpu_torch.ops.fused.apply_cluster_stack"),
    "quest_tpu/ops/fused.py:271": (
        "K12", "quest_tpu_torch/csrc/window.cu", "swap_cluster_kernel",
        "quest_tpu_torch.ops.fused.apply_swap_cluster_stack"),
    "scripts/probes/profile_dma.py:52": (
        "P1", "quest_tpu_torch/csrc/probes.cu", "stream_pass_kernel",
        "quest_tpu_torch.ops.stream.stream_pass"),
    "scripts/probes/kernel_microbench.py:104": (
        "P2", "quest_tpu_torch/csrc/window.cu", "window_pass_kernel",
        "quest_tpu_torch.probes.kernel_microbench.apply_offset_cluster"),
    "scripts/probes/probe_kernel_variants.py:93": (
        "P3", "quest_tpu_torch/csrc/window.cu", "window_pass_kernel",
        "quest_tpu_torch.probes.probe_kernel_variants.sep_window"),
    "scripts/probes/profile_rank_kernels.py:106": (
        "P4", "quest_tpu_torch/csrc/window.cu", "window_pass_kernel",
        "quest_tpu_torch.probes.profile_rank_kernels.rank_pass"),
    "scripts/probes/profile_rank_kernels.py:156": (
        "P5", "quest_tpu_torch/csrc/window.cu", "window_pass_kernel",
        "quest_tpu_torch.probes.profile_rank_kernels.rank_pass"),
    "scripts/probes/profile_rank_kernels.py:206": (
        "P6", "quest_tpu_torch/csrc/window.cu", "window_pass_kernel",
        "quest_tpu_torch.probes.profile_rank_kernels.rank_pass"),
    "scripts/probes/profile_rank_kernels.py:333": (
        "P7", "quest_tpu_torch/csrc/window.cu", "window_pass_kernel",
        "quest_tpu_torch.probes.profile_rank_kernels.rank_pass"),
    "scripts/probes/probe_flip_pallas.py:109": (
        "P8", "quest_tpu_torch/csrc/paulis.cu", "pauli_rotation_kernel",
        "quest_tpu_torch.probes.probe_flip_pallas.flip_program"),
}

# the probe modules, in the order chip_smoke.py runs them
PROBES = ("profile_dma", "kernel_microbench", "probe_kernel_variants",
          "profile_rank_kernels", "probe_flip_pallas")
