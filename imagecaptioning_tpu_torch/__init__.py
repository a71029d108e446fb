"""imagecaptioning_tpu_torch — the PyTorch/CUDA port of imagecaptioning_tpu.

The JAX package beside it stays the reference: every module here keeps
its counterpart's path and names, and the tests hold each one against
it on the same inputs. This package imports `torch`, `numpy` and
(lazily) `PIL` and `matplotlib`, and nothing of JAX or of the JAX
package.

Ported so far: the ground-truth-box dense captioner with both caption
heads (the transformer head of the reference's default GT config, and
the LSTM head), serving (VGG16 trunk → hand-written CUDA ROI-pooling
kernel → VGG classifier head → caption head → greedy/beam region decode,
driven by ``python -m imagecaptioning_tpu_torch.infer --model-type gt``)
and training (the ROI backward as hand-written CUDA kernels, driven by
``python -m imagecaptioning_tpu_torch.traingt``); the RPN DenseCap model
(``train_DenseCap``); and the four AlexCap caption families: the LSTM,
attention-LSTM and Transformer captioners on ResNet-101 and the ViT-B/16
captioner (``train_LSTM``, ``train_LSTMwAttention``,
``train_Transformer``, ``train_ViTB``; ``infer --model-type
lstm|lstm_attention|transformer|vitb``); and the evidence runs
(``python -m imagecaptioning_tpu_torch.evidence_run``).

Layout
------
- ``config``    `DenseConfig` and `CaptionConfig` (copies of the JAX
                package's configs)
- ``data``      vocab and tokenizer, the VG and Face2Text loaders, the
                device-resident store, ImageNet normalization and the
                ResNet preprocess, synthetic data, image processing
- ``ops``       tokens, loss, LSTM, the reference-math transformer, ROI
                pooling forward and backward (+ their CUDA kernels in
                ``csrc``)
- ``models``    VGG16, ResNet, ViT-B/16, the LSTM, attention and
                transformer caption heads, the GT dense captioner, the
                RPN model, the AlexCap captioners, fixed-shape
                greedy/beam decoding (with attention maps) and the
                decode API
- ``train``     the dense drivers and the AlexCap driver (optimizers,
                train steps, CLI)
- ``eval``      the dense mAP/METEOR evaluators, the AlexCap scorer
                (METEOR, BLEU, BLEU-4, CIDEr-D over copies of nltk's
                Porter stemmer, METEOR and BLEU) and their eval loops
- ``utils``     device resolution, weights and training state carried
                over from the JAX tree (and a ViT encoder back to
                it), pretrained-encoder init, checkpoints, JSON
                histories, curves and attention overlays
"""

__version__ = "0.1.0"
