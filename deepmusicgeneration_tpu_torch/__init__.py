"""deepmusicgeneration_tpu_torch — the PyTorch/CUDA port of deepmusicgeneration_tpu.

Genre continuation on an NVIDIA H100, MIDI in and MIDI out: single stream
(MusicLearner.load → predict_nw_genre → GenerationEngine.generate_batch at
B = 1, the hand-written ``slab_w8`` decode kernel) and batched
(tasks.serve.GenerationService or generate_batch at B % 8 == 0, the
hand-written flash prefill and ``slab_ar_w8`` decode kernels). Imports torch,
numpy and the standard library only; nothing of JAX or of the JAX package.
"""

__version__ = "0.1.0"
