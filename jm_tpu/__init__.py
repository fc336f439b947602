"""jm_tpu — an accelerator-native H.264/AVC encode/decode engine in JAX/XLA.

A from-scratch reimplementation of the capabilities of the JM 19.0 reference
software (lencod/ldecod): Baseline/Main/High-profile encoding with
full-search and EPZS/HME fast motion estimation, quarter-pel interpolation,
intra prediction, 4x4/8x8 integer transforms, normal/trellis (RDOQ)
quantization with custom scaling matrices and adaptive rounding, CAVLC and
CABAC entropy coding, in-loop deblocking, RD-optimized mode decision —
redesigned for batched accelerator execution: the production P/I encode pipeline runs as batched
jitted device stages (ops/enc_jax.py, ops/intra_jax.py), optionally
MB-row-sharded over a device mesh with halo exchange
(parallel/sp_pipeline.py); host Python handles bit-serial entropy coding
with hot loops in a native C++ runtime (native/).

Package layout:
  common/     shared types, constants, normative tables, FMO, conformance
  bitstream/  NAL framing, bit readers/writers, Exp-Golomb, RTP
  ops/        batched compute kernels (numpy reference + jnp device twins)
  decoder/    two-phase decoder (host parse -> batched reconstruction)
  encoder/    encoder (device pipeline + serial reference path, RDO/RDOQ,
              EPZS, rate control, WP estimation, SEI/syntax writers)
  parallel/   mesh/sharding helpers + MB-row-sharded encode pipeline
  native/     C++ runtime (bit reader, CABAC core, CAVLC serializer,
              deblock edge loops) via the CPython C API
  tools/      lencod/ldecod CLI twins, rtpdump, rtp_loss, imgio, trace
"""

__version__ = "0.1.0"
