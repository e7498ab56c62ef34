"""Hand-written Hopper kernels of the port and their plain versions.

* ``seg_sum``      — K1, banded weighted gather + segment sum (replaces the
                     TPU kernel ``repro/kernels/seg_sum.py::_na_kernel``);
                     also the packed edge-block format.
* ``edge_softmax`` — K2, per-destination online softmax statistics
                     (replaces ``repro/kernels/edge_softmax.py::_stats_kernel``).
* ``spgemm_bsr``   — K3, block-sparse boolean SpGEMM over tile-padded 0/1
                     matrices, the device SGB composition (replaces
                     ``repro/kernels/spgemm_bsr.py::_spgemm_kernel``).
* ``flash_attention`` — K4, block-wise attention forward with the online
                     softmax (replaces
                     ``repro/kernels/flash_attention.py::_fa_kernel``);
                     head dims the kernel does not take run zero-padded.
* ``ssd_scan``     — K5, the Mamba2 SSD chunked scan (replaces
                     ``repro/kernels/ssd_scan.py::_ssd_kernel``).
* ``ops``          — the NA operations, SGB compositions, attention and SSD
                     scan built on them.
* ``cuda_build``   — nvcc build and ctypes binding of ``csrc/*.cu``.

A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
"""
