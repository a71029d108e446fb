"""imagecaptioning_tpu_torch — the PyTorch/CUDA port of imagecaptioning_tpu.

The JAX package beside it stays the reference: every module here keeps
its counterpart's path and names, and the tests hold each one against
it on the same inputs. This package imports `torch`, `numpy` and
(lazily) `PIL`, and nothing of JAX or of the JAX package.

Ported so far: the ground-truth-box dense captioner's serving path with
the LSTM head (VGG16 trunk → hand-written CUDA ROI-pooling kernel → VGG
classifier head → LSTM head → greedy/beam region decode), driven by
``python -m imagecaptioning_tpu_torch.infer --model-type gt``.

Layout
------
- ``config``    `DenseConfig` (copy of the JAX package's dense config)
- ``data``      vocab, ImageNet normalization, image processing/proposals
- ``ops``       tokens, LSTM, ROI pooling (+ its CUDA kernel in ``csrc``)
- ``models``    VGG16, the LSTM caption head, the GT dense captioner,
                fixed-shape greedy/beam decoding and the region decode API
- ``utils``     device resolution, weights carried over from the JAX tree
"""

__version__ = "0.1.0"
