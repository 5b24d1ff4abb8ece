"""ganleaks_tpu_torch — the PyTorch / CUDA port of ``ganleaks_tpu``.

The JAX package beside it is the reference. This package runs the
full-black-box (fbb) membership attack with the ``l2`` / ``l2-lpips``
distances and its ROC evaluation on an NVIDIA GPU:

* images (uint8 NHWC) are dequantised through the exact lookup table
  (``ops/distance``);
* each image is featurised once into an embedding — the pixel part plus
  the five scaled, channel-normalised VGG16 taps (``ops/lpips``) — so the
  attack distance is a squared Euclidean distance; the ``taps`` engines
  write the taps as parts through the hand-written tap epilogue kernel
  (``ops/lpips/epilogue``, ``csrc/tap_epilogue.cu``), int8-quantised for
  ``taps-int8``;
* a streamed 1-NN over the synthetic set (``ops/knn``) keeps ``torch.min``'s
  first-index tie-break; the ``pallas`` and ``taps`` engines fold each
  block through the hand-written CUDA distance+argmin kernel
  (``ops/knn_fused``, ``csrc/knn_argmin.cu``), ``taps-int8`` through int8
  products; ``two_pass`` takes each query's top-k candidates (the fused
  top-k kernel, ``csrc/knn_topk.cu``), re-ranks them in float32 and
  certifies the result;
* ``attack/fbb`` writes the reference's artifacts and ``attack/eval_roc``
  scores them.

The package imports torch, numpy and the standard library only. PyYAML,
Pillow and matplotlib are imported inside the functions that need them.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``).
"""

__version__ = "0.1.0"
