#!/usr/bin/env python
"""Evidence runs — port of the root `evidence_run.py`: the real training
drivers on the learnable synthetic datasets (`data/synthetic.py`), whose
captions describe the rendered images or boxes, so that the held-out
METEOR and mAP that select the best checkpoint measure grounding, not
recall.

- `--model gt`: `dense_driver.train_gt` (the LSTM head, best by val mAP)
  on the learnable VG set at 128², then the test split's GT-protocol
  eval from the best checkpoint; `--model rpn`: `train_rpn` (the 5-loss
  objective, clip 5) at 256², the DenseCap-protocol test eval from the
  best checkpoint, and the per-eval breakdown of detection against
  captioning (`--rpn-anchors matched` swaps in a ladder matched to the
  set's 32–120 px boxes; `--rpn-box-decay` sums the box decay into the
  loss);
- `--model lstm|lstm_attention|transformer|vitb`: `driver.train` on the
  learnable Face2Text set, best by val METEOR, the test split's greedy
  and beam 1–5 evals, the loss and METEOR curves (`display_logs`) and,
  for the attention families, a held-out image's per-word attention
  overlay; ViT-B trains from scratch, then again with its encoder frozen
  and initialised from run 1's best encoder (`encoder_init`, the `.npz`
  `weights.vit_flat_variables` writes).

The trunks are CPU-sized as the JAX script's (`vgg_stages=3`,
`backbone_stages=(1,1,1,1)`, a 7×7 ViT, a 2-layer 128-wide transformer);
the drivers and architectures are the full ones. Artifacts under
`--out`: `loss_history_<tag>.json`, `results_history_<tag>.json`,
`summary_<tag>.json` (with `final_test`, `history` and `truncated`),
`<tag>.png` / `<tag>_breakdown.png` curves and `vis_<tag>*.jpg`
overlays; the best checkpoint `best_model_<tag>.ckpt`. fp32 throughout.

    python -m imagecaptioning_tpu_torch.evidence_run --model gt \\
        --epochs 2 --images 32 [--device cpu]

Runs on the first CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os


def _stamp_history(printable: dict, summary: dict, result_file: str) -> dict:
    """Stamp the summary with the eval count and last eval iteration of
    its results history, and `truncated` where the run stopped before its
    own max_iter."""
    try:
        with open(result_file) as f:
            hist = json.load(f)
    except Exception:
        hist = []
    printable["history"] = {
        "file": os.path.basename(result_file),
        "evals": len(hist),
        "final_eval_iter": hist[-1]["iter"] if hist else None,
    }
    max_iter = summary.get("max_iter")
    printable["truncated"] = bool(max_iter) and summary["iters"] < max_iter
    return printable


# the keys of the JAX drivers' summaries that the summary files keep
GT_KEYS = ("iters", "max_iter", "final_loss", "best_val_score", "best_iter",
           "loss_file", "result_file", "save_path")
RPN_KEYS = ("iters", "max_iter", "final_losses", "best_val_score",
            "best_iter")
CAPTION_KEYS = GT_KEYS + ("final_test",)


def _printable(summary: dict, keys) -> dict:
    return {k: summary[k] for k in keys if k in summary}


def _restore_best(model, save_path: str) -> None:
    """The best checkpoint's weights into `model`, read from `save_path`
    itself (not `resume_path`, which would prefer a newer preemption
    checkpoint); nothing where there is none."""
    import torch

    from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
    if os.path.isfile(save_path):
        dev = next(model.parameters()).device
        model.load_state_dict(ckptlib.restore_checkpoint(
            save_path, torch.device(dev))["model"])


def _attention_vis(summary, out_dir, tag):
    """Decode one test image with alphas and render the per-word
    attention grid (generate_vis.py:59-85). Show-Attend-Tell alphas
    cover the grid; the ViT decoder's cross-attention covers the class
    token and the grid, and the class column is dropped."""
    import numpy as np
    import torch

    from imagecaptioning_tpu_torch.data import transforms
    from imagecaptioning_tpu_torch.models import api
    from imagecaptioning_tpu_torch.utils.visualize import generate_caption_vis

    model, loader = summary["model"], summary["loader"]
    img_u8, gt = next(loader.epoch_batches(2, 1))
    dev = next(model.parameters()).device
    x = transforms.resnet_v2_preprocess(torch.from_numpy(img_u8).to(dev))
    greedy = api.make_greedy_fn(model, loader.getSeqLength() + 1,
                                collect_alphas=True)
    model.eval()
    toks, alphas = greedy(x)                           # alphas (B, L, P)
    caption = loader.vocab.decode_sequence(toks.cpu().numpy())[0]
    gt_caption = loader.vocab.decode_sequence(np.asarray(gt))[0]
    n_words = len(caption.split())
    a = alphas.float().cpu().numpy()[0, :n_words]
    n = a.shape[-1]
    g = int(np.sqrt(n))
    if g * g != n and int(np.sqrt(n - 1)) ** 2 == n - 1:
        a = a[..., 1:]                  # drop the ViT class token
    return generate_caption_vis(np.asarray(img_u8[0]), caption, a,
                                out_dir=out_dir, name=f"vis_{tag}",
                                gt_caption=gt_caption)


def run_gt(args):
    """Dense-captioning evidence: traingt's loop (best by val mAP) on the
    learnable VG set, scored by the GT protocol
    (`AlexGTModel/eval/eval_gt.py:113-168`)."""
    from imagecaptioning_tpu_torch.config.dense_configs import get_gt_config
    from imagecaptioning_tpu_torch.eval import dense_eval
    from imagecaptioning_tpu_torch.train import dense_driver

    tag = f"gt_learnable_bs{args.batch_size}"
    cfg = get_gt_config().replace(
        data_h5="/nonexistent", from_checkpoint=False,
        # eval_batch_size divides the 9-image val and test splits of 64
        # images (padded_batches drops a ragged tail)
        batch_size=args.batch_size, max_regions=4, eval_batch_size=3,
        use_lstm=True,                # the reference's best GT family
        learning_rate=args.lr, compute_dtype="float32",
        vgg_stages=3, loss_log_pad=5,
        loss_file=os.path.join(args.out, f"loss_history_{tag}.json"),
        result_file=os.path.join(args.out,
                                 f"results_history_{tag}.json"),
        save_path=os.path.join(args.out, f"best_model_{tag}.ckpt"),
    )
    max_iter = args.epochs * max((args.images * 70 // 100)
                                 // args.batch_size, 1)
    summary = dense_driver.train_gt(
        cfg, device=args.device, synthetic_learnable=True,
        synthetic_images=args.images, synthetic_image_size=128,
        max_iter_override=max_iter,
        eval_every_override=max(max_iter // 10, 1))

    # the test split from the best (by val mAP) checkpoint; train_gt
    # renames the artifacts (name_gt_model), so read them off the summary
    model, loader = summary["model"], summary["loader"]
    _restore_best(model, summary["save_path"])
    final = dense_eval.eval_split_gt(
        model, loader, split=2, batch_size=cfg.eval_batch_size,
        max_regions=cfg.max_regions, return_records=True)
    printable = _printable(summary, GT_KEYS)
    printable["final_test"] = final
    _stamp_history(printable, summary, summary["result_file"])
    with open(os.path.join(args.out, f"summary_{tag}.json"), "w") as f:
        json.dump(printable, f, indent=1, default=str)

    png = None
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        hist = json.load(open(summary["result_file"]))
        its = [o["iter"] for o in hist]
        fig, ax = plt.subplots(2, 1, sharex="col", figsize=(7, 5))
        ax[0].plot(its, [o["ap_results"]["map"] for o in hist], "go-")
        ax[0].set_ylabel("val mAP")
        ax[0].set_title("GT dense captioning on the learnable VG set")
        ax[1].plot(its, [o["ap_results"].get("meteor", 0.0)
                         for o in hist], "bo-")
        ax[1].set_ylabel("val METEOR")
        ax[1].set_xlabel("iter")
        fig.tight_layout()
        png = os.path.join(args.out, f"{tag}.png")
        fig.savefig(png, dpi=120)
    except Exception as e:
        print(f"curve PNG skipped: {e}")
    print(json.dumps({"best_val_map": summary.get("best_val_score"),
                      "final_test": final.get("ap_results"),
                      "curves": png}, default=str))
    return {**summary, "final_test": final}


def run_rpn(args):
    """Full-RPN evidence: `train_rpn` (the 5-loss objective, best by val
    mAP) on the learnable VG set, detection and captioning learned from
    scratch, scored by the DenseCap protocol (eval_utils.py:98-169)."""
    from imagecaptioning_tpu_torch.config.dense_configs import \
        get_densecap_config
    from imagecaptioning_tpu_torch.train import dense_driver

    tag = f"rpn_learnable_bs{args.batch_size}{args.suffix}"
    # 'matched': the reference's 45/90/180/360 ladder is made for 720 px
    # VG images; for this set's 32-120 px boxes no anchor clears the 0.7
    # positive IoU on scale alone. This ladder covers sqrt-area 32..126
    # in ≤1.42× steps and aspect 0.4..2.5 in ≤1.6× steps.
    anchor_kw = {}
    if args.rpn_anchors == "matched":
        anchor_kw = dict(anchor_sizes=(32.0, 45.0, 64.0, 90.0, 126.0),
                         anchor_ratios=(0.4, 0.63, 1.0, 1.6, 2.5))
    if args.rpn_box_decay:
        # the trans-field decay the reference computes and drops
        anchor_kw["apply_box_decay"] = True
    cfg = get_densecap_config().replace(
        **anchor_kw,
        data_h5="/nonexistent", from_checkpoint=args.resume,
        batch_size=args.batch_size, max_regions=4,
        learning_rate=args.lr, compute_dtype="float32",
        # the 5-loss objective diverges at these learning rates unclipped
        grad_clip_norm=5.0,
        vgg_stages=3, losses_log_every=5,
        loss_file=os.path.join(args.out, f"loss_history_{tag}.json"),
        result_file=os.path.join(args.out,
                                 f"results_history_{tag}.json"),
        save_path=os.path.join(args.out, f"best_model_{tag}.ckpt"),
    )
    max_iter = args.epochs * max((args.images * 70 // 100)
                                 // args.batch_size, 1)
    summary = dense_driver.train_rpn(
        cfg, device=args.device, synthetic_learnable=True,
        synthetic_images=args.images, synthetic_image_size=256,
        max_iter_override=max_iter,
        eval_every_override=max(max_iter // 8, 1))

    model, loader = summary["model"], summary["loader"]
    _restore_best(model, cfg.save_path)
    final = dense_driver.eval_split_rpn(
        model, loader, split=2, max_regions=cfg.max_regions,
        return_records=True)
    printable = _printable(summary, RPN_KEYS)
    printable["final_test"] = final
    printable["anchors"] = {"ladder": args.rpn_anchors,
                            "sizes": list(cfg.anchor_sizes),
                            "ratios": list(cfg.anchor_ratios),
                            "apply_box_decay": cfg.apply_box_decay}
    _stamp_history(printable, summary, cfg.result_file)
    with open(os.path.join(args.out, f"summary_{tag}.json"), "w") as f:
        json.dump(printable, f, indent=1, default=str)
    # detection (localization-only AP, proposal recall) against the full
    # captioning mAP over the evals
    png = None
    try:
        with open(cfg.result_file) as f:
            hist = json.load(f)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        its = [h["iter"] for h in hist]
        ap = [h["ap_results"] for h in hist]
        fig, axs = plt.subplots(2, 1, sharex="col", figsize=(7, 6))
        axs[0].plot(its, [a["map"] for a in ap], "go-", label="mAP")
        axs[0].plot(its, [a.get("detmap", 0.0) for a in ap], "ks--",
                    label="detmap (localization only)")
        axs[0].set_ylabel("AP")
        axs[0].set_title("RPN dense captioning: detection vs captioning")
        axs[0].legend()
        for thr, style in (("0.50", "bo-"), ("0.70", "c^-")):
            key = f"{thr}_recall_at_all"
            axs[1].plot(
                its,
                [a.get("proposal_recall", {}).get(key, 0.0) for a in ap],
                style, label=f"proposal recall@IoU{thr}")
        axs[1].set_ylabel("recall")
        axs[1].set_xlabel("iter")
        axs[1].legend()
        fig.tight_layout()
        png = os.path.join(args.out, f"{tag}_breakdown.png")
        fig.savefig(png, dpi=120)
    except Exception as e:
        print(f"breakdown PNG skipped: {e}")
    print(json.dumps({"best_val_map": summary.get("best_val_score"),
                      "final_test": final.get("ap_results"),
                      "curves": png}, default=str))
    return {**summary, "final_test": final}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="lstm",
                    choices=["lstm", "lstm_attention", "transformer",
                             "vitb", "gt", "rpn"])
    ap.add_argument("--images", type=int, default=None,
                    help="default: 256 (caption families) / 64 (dense)")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="default: 12 (caption) / 4 (gt) / 2 (rpn)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="runs/evidence")
    ap.add_argument("--suffix", default="",
                    help="appended to the artifact tag (so experiment "
                         "variants land beside the baseline artifacts)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the run's checkpoint (.preempt "
                         "preferred when newer) and append to its "
                         "histories (the RPN run)")
    ap.add_argument("--rpn-box-decay", action="store_true",
                    help="RPN runs: sum the 0.5*w*|trans|^2 decay into "
                         "the total (the reference computes and drops "
                         "it, RoiModel.py:238)")
    ap.add_argument("--rpn-anchors", default="reference",
                    choices=["reference", "matched"],
                    help="'reference' = the 720px-VG ladder the reference "
                         "hard-codes; 'matched' = a ladder matched to the "
                         "synthetic set's box sizes (32-120px at 256px "
                         "images)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from imagecaptioning_tpu_torch.utils.platform import resolve_device
    args.device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    # per-family defaults only where the flag was omitted
    if args.model in ("gt", "rpn"):
        if args.batch_size is None:
            args.batch_size = 4 if args.model == "gt" else 2
        if args.images is None:
            args.images = 64
        return run_gt(args) if args.model == "gt" else run_rpn(args)
    if args.batch_size is None:
        args.batch_size = 12
    if args.images is None:
        args.images = 256

    from imagecaptioning_tpu_torch.config.configs import get_config
    from imagecaptioning_tpu_torch.data.synthetic import (
        make_learnable_face2text_arrays)
    from imagecaptioning_tpu_torch.train.driver import train
    from imagecaptioning_tpu_torch.utils.visualize import display_logs

    # the train split's size from the dataset itself (seed 123, the
    # config's; train() builds the same arrays)
    arrays, _ = make_learnable_face2text_arrays(num_images=args.images,
                                                seed=123)
    n_train = int((arrays["split"] == 0).sum())

    def base_cfg(tag):
        return get_config(args.model).replace(
            data_h5="/nonexistent",               # synthetic data
            from_checkpoint=False,
            batch_size=args.batch_size,
            # the reference's convention: one "epoch" is one data pass
            save_checkpoint_every=n_train,
            num_epochs=args.epochs,
            learning_rate=args.lr,
            use_scheduler=True,
            clip_grad=True,
            use_dropout=False,
            finetuning_after_nepoch=1,
            compute_dtype="float32",
            backbone_stages=(1, 1, 1, 1),         # CPU-sized ResNet
            eval_val_batch_size=args.batch_size,
            use_beam=True, beam_size=3,
            loss_file=os.path.join(args.out, f"loss_history_{tag}.json"),
            result_file=os.path.join(args.out,
                                     f"results_history_{tag}.json"),
            save_path=os.path.join(args.out, f"best_model_{tag}.ckpt"),
        )

    def run(cfg):
        return train(cfg, device=args.device, synthetic_learnable=True,
                     synthetic_images=args.images)

    def finish(cfg, tag, summary):
        with open(cfg.result_file) as f:
            results_history = json.load(f)
        png = display_logs(results_history, tag, out_dir=args.out)
        vis = None
        if args.model in ("lstm_attention", "vitb"):
            try:
                vis = _attention_vis(summary, args.out, tag)
            except Exception as e:
                print(f"attention vis skipped: {e}")
        printable = _printable(summary, CAPTION_KEYS)
        _stamp_history(printable, summary, cfg.result_file)
        with open(os.path.join(args.out, f"summary_{tag}.json"),
                  "w") as f:
            json.dump(printable, f, indent=1, default=str)
        print(json.dumps({"tag": tag,
                          "best_val_meteor": summary.get("best_val_score"),
                          "final_test": printable.get("final_test"),
                          "curves": png, "vis": vis}, default=str))
        return summary

    if args.model == "vitb":
        import numpy as np

        from imagecaptioning_tpu_torch.utils.weights import vit_flat_variables

        # a 224-px ViT with 32-px patches (7×7 grid + class token)
        dims = dict(vit_dims=(224, 32, 2, 4, 32, 64), embedding_size=32,
                    num_layers=2, num_heads=4)
        # 1) from scratch (the reference's ViTB_drop0.1 config)
        tag_s = f"vitb_scratch_learnable_bs{args.batch_size}"
        cfg_s = base_cfg(tag_s).replace(trained_encoder=False,
                                        finetuning_after_nepoch=0, **dims)
        summary = finish(cfg_s, tag_s, run(cfg_s))
        # 2) pretrained and frozen (emb_ViTB_pretrained), the encoder
        #    initialised from run 1's best encoder through encoder_init
        model = summary["model"]
        _restore_best(model, cfg_s.save_path)
        npz = os.path.join(args.out, "vitb_encoder_pretrained.npz")
        np.savez(npz, **vit_flat_variables(model.encoder_vit))
        tag_p = f"vitb_pretrained_learnable_bs{args.batch_size}"
        cfg_p = base_cfg(tag_p).replace(trained_encoder=True,
                                        encoder_init=npz, **dims)
        return finish(cfg_p, tag_p, run(cfg_p))

    tag = f"{args.model}_learnable_bs{args.batch_size}"
    cfg = base_cfg(tag)
    if args.model == "transformer":
        # the full 512-wide config's embed_size**0.5 attention scaling
        # (TransformerModule.py:53) makes attention near uniform at this
        # scale; these dims ground quickly
        cfg = cfg.replace(transformer_size=128, num_layers=2, num_heads=4)
    return finish(cfg, tag, run(cfg))


if __name__ == "__main__":
    main()
