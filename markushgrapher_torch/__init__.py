"""PyTorch + CUDA (Hopper) port of the MarkushGrapher serving path.

Mirrors `markushgrapher_tpu`'s module names so each counterpart is easy to
find; the JAX package stays the numerical reference. The port keeps its own
copies of the host modules it needs (`config`, `arguments`, `data.*`,
`chem.*`, `utils.native`, `utils.viz` and the vendored vocabularies) and
imports nothing of `markushgrapher_tpu`. It imports `torch`, never `jax` or
`flax`.
"""
