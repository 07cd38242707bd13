"""Snow core, PyTorch port: the slice of ``repro.core`` that the
device-resident stable sweep runs on.

* wire sizes — :mod:`.ids`, :mod:`.messages` (DATA frame size only);
* delay and fault parameters — :mod:`.sim` (``LatencyModel``),
  :mod:`.faults` (``LossModel`` fields);
* planning — :mod:`.planner` (whole-tree batched planning on tensors);
* device engine — :mod:`.device_sweep` (per-seed generators, level
  sweep through the CUDA kernel, reductions) and :mod:`.engine`
  (``stable_sweep`` rows);
* :mod:`.convert` — numpy arrays of the JAX package in, tensors out.
"""
