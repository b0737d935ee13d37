"""Dispatch (`ops`), precision (`precision`), device selection (`device`),
the paper's analytics -- the transfer model (`transfer_model`), its Table
IV data (`paper_data`), the fitted energy model (`energy`), the H100
roofline (`roofline`) and the Hopper tile pricer (`tiling`) -- and the op
census (`op_census`).

JAX's `core/hlo_census.py` reads XLA's HLO text; its counterpart,
`op_census`, counts the aten ops a step dispatches, usually on "meta"
tensors built by `launch/specs.py` (JAX's `ShapeDtypeStruct` cell specs),
and `launch/dryrun.py` prices every (arch x shape) cell with it on one
H100.  JAX's `roofline.parse_collective_bytes` (HLO text) and
`energy.tpu_step_energy_j` (a TPU step) have no counterpart.  On the card
the port also counts launches from the kernel wrappers' counters and the
dispatch log, bytes from the transfer model and `kernels/quant.
launch_gemm_bytes`, and device time from CUDA events and `torch.profiler`,
as `chip_smoke.py` does.
"""
