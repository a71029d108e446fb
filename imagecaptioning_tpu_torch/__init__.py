"""imagecaptioning_tpu_torch — the PyTorch/CUDA port of imagecaptioning_tpu.

The JAX package beside it stays the reference: every module here keeps
its counterpart's path and names, and the tests hold each one against
it on the same inputs. This package imports `torch`, `numpy` and
(lazily) `PIL`, and nothing of JAX or of the JAX package.

Ported so far: the ground-truth-box dense captioner with both caption
heads (the transformer head of the reference's default GT config, and
the LSTM head), serving (VGG16 trunk → hand-written CUDA ROI-pooling
kernel → VGG classifier head → caption head → greedy/beam region
decode, driven by
``python -m imagecaptioning_tpu_torch.infer --model-type gt``) and
training (the ROI backward as hand-written CUDA kernels, driven by
``python -m imagecaptioning_tpu_torch.traingt``).

Layout
------
- ``config``    `DenseConfig` (copy of the JAX package's dense config)
- ``data``      vocab and tokenizer, the VG loader and ImageNet
                normalization, synthetic VG data, image processing
- ``ops``       tokens, loss, LSTM, the reference-math transformer, ROI
                pooling forward and backward (+ their CUDA kernels in
                ``csrc``)
- ``models``    VGG16, the LSTM caption head, the GT dense captioner
                (with its transformer head),
                fixed-shape greedy/beam decoding and the region decode API
- ``train``     the GT training driver (optimizer groups, train step)
- ``eval``      the GT mAP/METEOR evaluator and its eval loop
- ``utils``     device resolution, weights and training state carried
                over from the JAX tree, checkpoints, JSON histories
"""

__version__ = "0.1.0"
