"""deepmusicgeneration_tpu_torch — the PyTorch/CUDA port of deepmusicgeneration_tpu.

Single-stream genre continuation on an NVIDIA H100: MIDI in, MusicLearner.load
→ predict_nw_genre → GenerationEngine.generate_batch (B = 1, the hand-written
``slab_w8`` decode kernel), MIDI out. Imports torch, numpy and the standard
library only; nothing of JAX or of the JAX package.
"""

__version__ = "0.1.0"
