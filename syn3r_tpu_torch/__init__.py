"""syn3r_tpu_torch: the PyTorch/CUDA port of syn3r_tpu for one NVIDIA H100.

The JAX package ``syn3r_tpu`` stays the reference; this package mirrors its
module paths and holds each ported module to it. It imports torch and numpy
only, never jax or syn3r_tpu. The TPU kernels on the ported path have
hand-written Hopper counterparts under ``csrc/`` (built by
``kernels/build.py`` at first use), each with a plain torch version beside
its wrapper that CPU tensors take.

Ported so far: the guided SVD completion unit (``diffusion.pipeline.
load_svd_completion``), with the GEGLU feed-forward and flash-attention
kernels; and the 3DGS train step (``gs.trainer.GSTrainer``), with the tile
composite's forward and backward kernels; the per-scene loop
(``cli.train``, ``pipeline.orchestrator``) with the GroupNorm and LayerNorm
kernels, the post and prob completion variants and the LPIPS refine loss
(``models.lpips``); and the evaluation protocol (``cli.render``,
``cli.metrics``, ``cli.summarize``).
"""
