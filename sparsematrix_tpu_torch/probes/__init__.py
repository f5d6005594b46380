"""The JAX repository's probe and repro scripts, on the card.

One module for each script of ``benchmarks/`` and ``docs/`` that holds a
Pallas kernel, under the script's file name; each runs as
``python -m sparsematrix_tpu_torch.probes.<name>`` (on the card by
default; ``--device cpu`` runs the plain versions and prints no times)
and prints one JSON line a row:

* ``probe_xl_spmv``: the XL rowlane SpMV and its three ablations
  (``kernels/probe_rowlane.py``), with a profiler trace of the real call;
* ``probe_dualgather``: the dual- against the single-gather step;
* ``probe_sublane_slice``: the per-sublane-chunk (pooled) step;
* ``repro_dynamic_gather_shapes``: the row gather at any tile shape;
* ``repro_smem_lane_padding``: per-step metadata, flat or 2-D;
* ``probe_calibrate_xcheck``: the stream copy (kernel row 22) at 128 and
  256 MiB.

Importing builds nothing.
"""
