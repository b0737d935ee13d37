"""Dispatch (`ops`), precision (`precision`), device selection (`device`),
and the paper's analytics: the transfer model (`transfer_model`), its
Table IV data (`paper_data`), the fitted energy model (`energy`), the H100
roofline (`roofline`) and the Hopper tile pricer (`tiling`).

JAX's `core/hlo_census.py`, `launch/dryrun.py` and `launch/specs.py` get
no counterpart: they read XLA's HLO text and `ShapeDtypeStruct` cell
specs, which PyTorch does not produce.  The port counts launches from the
kernel wrappers' counters and the dispatch log, bytes from the transfer
model and `kernels/quant.launch_gemm_bytes`, and device time from CUDA
events and `torch.profiler`, as `chip_smoke.py` does.
"""
