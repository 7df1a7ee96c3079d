"""semanticsearch_tpu_torch: the hybrid semantic-search serving path in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It mirrors ``semanticsearch_tpu`` module by module (``ops/topk.py``,
``models/encoder.py``, ``index/query_engine.py``, ...) and imports nothing
of it and nothing of JAX. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. Kernel wrappers compute their plain PyTorch version
for CPU tensors only; a CUDA tensor reaches the kernel or an error.
"""
