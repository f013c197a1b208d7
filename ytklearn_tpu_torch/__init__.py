"""ytklearn_tpu_torch — the PyTorch/CUDA port of ytklearn_tpu for NVIDIA Hopper.

It grows beside the JAX package, slice by slice, and imports neither JAX
nor anything of ``ytklearn_tpu``. Ported so far: GBDT online serving
(``serve/``, ``cli serve``), whose fused rung runs the hand-written
heap-walk CUDA kernel, GBDT training on the device engine
(``gbdt/trainer.py``), whose histograms and routing run hand-written CUDA
kernels (``gbdt/csrc/``), and the convex families (linear,
multiclass_linear, FM, FFM: ``train.py``, ``models/``, ``optimize/``) in
plain PyTorch. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. See ROADMAP.md for what comes next.
"""
