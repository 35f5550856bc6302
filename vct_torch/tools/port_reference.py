"""CLI: convert a reference-LRCN or VideoMamba torch state_dict into a
vct_torch checkpoint.

    python -m vct_torch.tools.port_reference --state_dict lrcn_sd.pth --out DIR \
        --num_classes 4 --sequence_length 60 --cnn_backbone resnet50 \
        --rnn_type mamba --rnn_input_size 8 --rnn_layer 3 [--rnn_out all]
        [--classif_mode multiclass] [--bidirectional] [--classes a,b,c,d]
        [--scan_impl pallas] [--device cpu]
    python -m vct_torch.tools.port_reference --model_family videomamba ... \
        [--vm_d_model 512 --vm_d_inner 2048 --vm_n_state 16 --vm_dt_rank 16
         --vm_n_layer 4 --vm_temporal_mode mean]

The port of ``vct/tools/port_reference.py``, with the same options and
``--scan_impl`` (the manifest's ``model.scan_impl``: "pallas" serves the
Mamba head through the card's scan kernel). The
reference saves whole torch modules (``train_eval.py:53``); export their
state_dict in any torch environment (``torch.save(torch.load(p).state_dict(),
out)``) and feed it here. The model is built and ported on the card unless
``--device`` names another device; the result is a vct_torch checkpoint
that ``vct_torch.serve.deployment.load_model`` loads.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--state_dict", required=True, help=".pth/.npz state_dict")
    p.add_argument("--out", required=True, help="output checkpoint dir")
    p.add_argument("--model_family", default="lrcn", choices=["lrcn", "videomamba"])
    p.add_argument("--num_classes", type=int, required=True)
    p.add_argument("--sequence_length", type=int, required=True)
    p.add_argument("--cnn_backbone", default="resnet50")
    p.add_argument("--rnn_type", default="mamba", choices=["lstm", "gru", "mamba"])
    p.add_argument("--rnn_input_size", type=int, default=8)
    p.add_argument("--rnn_layer", type=int, default=3)
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--mult_factor", type=int, default=4)
    p.add_argument("--rnn_out", default="all", choices=["all", "last"])
    p.add_argument("--classif_mode", default="multiclass",
                   choices=["multiclass", "multiple_binary"])
    p.add_argument("--bidirectional", action="store_true")
    p.add_argument("--img_height", type=int, default=80)
    p.add_argument("--img_width", type=int, default=80)
    p.add_argument("--classes", default="",
                   help="comma-separated class names for the manifest")
    p.add_argument("--scan_impl", default="associative", choices=["associative", "scan", "pallas"],
                   help="the Mamba head's scan; pallas: the card's kernel (K3)")
    # VideoMamba's sizes (lrcn/videomamba.py defaults)
    p.add_argument("--vm_d_model", type=int, default=512)
    p.add_argument("--vm_d_inner", type=int, default=2048)
    p.add_argument("--vm_n_state", type=int, default=16)
    p.add_argument("--vm_dt_rank", type=int, default=16)
    p.add_argument("--vm_n_layer", type=int, default=4)
    p.add_argument("--vm_temporal_mode", default="mean")
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    from vct_torch.core.config import Config
    from vct_torch.models import build_model
    from vct_torch.models.backbones.port import load_state_dict_file
    from vct_torch.models.lrcn_port import port_reference_lrcn, port_reference_videomamba
    from vct_torch.train.checkpoint import save_checkpoint

    overrides = {
        "model.model_family": args.model_family,
        "model.num_classes": str(args.num_classes),
        "model.cnn_backbone": args.cnn_backbone,
        "model.rnn_type": args.rnn_type,
        "model.rnn_input_size": str(args.rnn_input_size),
        "model.rnn_layer": str(args.rnn_layer),
        "model.mult_factor": str(args.mult_factor),
        "model.rnn_out": args.rnn_out,
        "model.classif_mode": args.classif_mode,
        "model.bidirectional": str(args.bidirectional).lower(),
        "model.scan_impl": args.scan_impl,
        "data.sequence_length": str(args.sequence_length),
        "data.img_height": str(args.img_height),
        "data.img_width": str(args.img_width),
        "model.vm_d_model": str(args.vm_d_model),
        "model.vm_d_inner": str(args.vm_d_inner),
        "model.vm_n_state": str(args.vm_n_state),
        "model.vm_dt_rank": str(args.vm_dt_rank),
        "model.vm_n_layer": str(args.vm_n_layer),
        "model.vm_temporal_mode": args.vm_temporal_mode,
    }
    if args.hidden_size is not None:
        overrides["model.hidden_size"] = str(args.hidden_size)
    cfg = Config().replace(**overrides)
    classes = ([c for c in args.classes.split(",") if c]
               or [f"class_{i}" for i in range(args.num_classes)])
    if len(classes) != args.num_classes:
        raise SystemExit(
            f"--classes names {len(classes)} classes but --num_classes is "
            f"{args.num_classes}; the manifest must label every head output")

    model = build_model(cfg.model, cfg.data.sequence_length, device=args.device)
    porter = (port_reference_videomamba if args.model_family == "videomamba"
              else port_reference_lrcn)
    porter(model, load_state_dict_file(args.state_dict), cfg.model)
    path = save_checkpoint(args.out, model.state_dict(), cfg, classes)
    print(f"Ported checkpoint written to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
