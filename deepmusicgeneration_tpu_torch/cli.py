"""Command-line interface of the PyTorch port.

    python -m deepmusicgeneration_tpu_torch generate --midi in.mid --genre jazz
    python -m deepmusicgeneration_tpu_torch remix --midi in.mid --pred-type notes
    python -m deepmusicgeneration_tpu_torch harmonize --midi in.mid
    python -m deepmusicgeneration_tpu_torch serve --port 8711 [--continuous]
    python -m deepmusicgeneration_tpu_torch tokenize --midi in.mid
    python -m deepmusicgeneration_tpu_torch preprocess --src midis/ --out cache/
    python -m deepmusicgeneration_tpu_torch train --data cache/ --ckpt ckpt/ [--small]

``generate`` (genre-conditioned continuation), ``remix`` (mask infill),
``harmonize`` (seq2seq), ``serve`` (the HTTP endpoint), ``tokenize``,
``preprocess`` (MIDI corpus to cached npenc files) and ``train`` (the genre
LM) are ported; ``import-checkpoint`` is still to port (ROADMAP.md).
``--device cpu`` runs on the CPU; the default is the CUDA card.
"""

from __future__ import annotations

import argparse
import sys


def cmd_generate(args):
    from .tasks.generate import predict_nw_genre
    from .train.learner import MusicLearner
    learner = MusicLearner.load(args.ckpt, device=args.device)
    full = predict_nw_genre(
        learner, args.midi, genre=args.genre, max_len=args.max_len,
        cutoff_beat=args.cutoff_beat, mem_len=args.mem_len,
        temperature_notes=args.temp_notes, temperature_duration=args.temp_dur,
        temperature_ins=args.temp_ins,
        allowed_ins=args.allowed_ins.split(",") if args.allowed_ins else None,
        output_bpm=args.bpm, seed=args.seed)
    full.write_midi(args.out, bpm=args.bpm)
    print(f"wrote {args.out} ({len(full)} tokens)")


def cmd_remix(args):
    from .app.app_utils import createRemixModel, predictMaskModel
    model = createRemixModel(ckpt_path=args.ckpt, device=args.device)
    pred = predictMaskModel(
        model, args.midi, genre=args.genre, pred_type=args.pred_type,
        mask_proportion=args.mask_proportion, cutoff_beat=args.cutoff_beat,
        output_bpm=args.bpm, seed=args.seed)
    pred.write_midi(args.out, bpm=args.bpm)
    print(f"wrote {args.out} ({len(pred)} tokens)")


def cmd_harmonize(args):
    from .app.app_utils import createS2SModel
    from .tasks.harmonize import s2s_predict_from_midi
    model = createS2SModel(ckpt_path=args.ckpt, device=args.device)
    multitrack = s2s_predict_from_midi(model, args.midi, n_words=args.max_len,
                                       pred_melody=args.pred_melody, seed=args.seed)
    multitrack.write_midi(args.out, bpm=args.bpm)
    print(f"wrote {args.out}")


def cmd_serve(args):
    from .app.server import serve
    serve(args.port, args.host, args.max_batch, continuous=args.continuous,
          device=args.device)


def cmd_tokenize(args):
    from .codec.item import MusicItem
    from .vocab import MusicVocab
    item = MusicItem.from_file(args.midi, MusicVocab.create(), genre=args.genre or None)
    text = item.to_text()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out} ({len(item)} tokens)")
    else:
        print(text)


def cmd_preprocess(args):
    from pathlib import Path
    from .train.preprocess import process_all
    midis = sorted(Path(args.src).rglob("*.mid")) + sorted(Path(args.src).rglob("*.midi"))
    out = process_all(midis, args.out, timeout_s=args.timeout, verbose=True)
    print(f"tokenized {len(out)}/{len(midis)} files → {args.out}")


def cmd_train(args):
    from .models.config import btp_phase1_config
    from .train.data import LMStreamLoader
    from .train.learner import MusicLearner
    from .train.preprocess import load_corpus
    from .vocab import MusicVocab
    vocab = MusicVocab.create()
    corpus = load_corpus(args.data, vocab, limit=args.limit)
    if not corpus:
        print("no usable .npy files found", file=sys.stderr)
        raise SystemExit(1)
    n_val = max(len(corpus) // 10, 1)
    cfg = btp_phase1_config(len(vocab))
    if args.small:
        cfg = cfg.replace(n_layers=2, d_model=128, d_inner=256, n_heads=4,
                          d_head=32, ctx_len=128, mem_len=128)
    learner = MusicLearner(cfg, vocab, device=args.device)
    train_loader = LMStreamLoader(corpus[n_val:], vocab, bs=args.bs,
                                  bptt=cfg.ctx_len, encode_position=cfg.encode_position,
                                  transpose_range=cfg.transpose_range)
    valid_loader = LMStreamLoader(corpus[:n_val], vocab, bs=args.bs,
                                  bptt=cfg.ctx_len, shuffle=False,
                                  transpose_range=None,
                                  encode_position=cfg.encode_position)
    learner.fit_one_cycle(train_loader, epochs=args.epochs, lr=args.lr,
                          valid_loader=valid_loader, save_best_to=args.ckpt)
    learner.save(args.ckpt)
    print(f"saved checkpoint → {args.ckpt}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="deepmusicgeneration_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="genre-conditioned continuation")
    g.add_argument("--midi", required=True)
    g.add_argument("--genre", default="auto")
    g.add_argument("--out", default="outputs/genre_output.mid")
    g.add_argument("--ckpt", default="./checkpoints/synth_genre_model")
    g.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    g.add_argument("--max-len", type=int, default=512)
    g.add_argument("--cutoff-beat", type=float, default=32)
    g.add_argument("--mem-len", type=int, default=512)
    g.add_argument("--temp-notes", type=float, default=1.8)
    g.add_argument("--temp-dur", type=float, default=1.8)
    g.add_argument("--temp-ins", type=float, default=1.0)
    g.add_argument("--allowed-ins", default=None)
    g.add_argument("--bpm", type=float, default=120)
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("remix", help="mask-infill remix (multitask model)")
    r.add_argument("--midi", required=True)
    r.add_argument("--genre", default="auto")
    r.add_argument("--out", default="outputs/remix_output.mid")
    r.add_argument("--ckpt", default="./checkpoints/mask_music_model")
    r.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    r.add_argument("--pred-type", choices=["notes", "duration"], default="notes")
    r.add_argument("--mask-proportion", type=float, default=0.6)
    r.add_argument("--cutoff-beat", type=float, default=32)
    r.add_argument("--bpm", type=float, default=120)
    r.add_argument("--seed", type=int, default=0)
    r.set_defaults(fn=cmd_remix)

    h = sub.add_parser("harmonize", help="seq2seq melody / accompaniment")
    h.add_argument("--midi", required=True)
    h.add_argument("--out", default="outputs/s2s_output.mid")
    h.add_argument("--ckpt", default="./checkpoints/s2s_model")
    h.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    h.add_argument("--max-len", type=int, default=200)
    h.add_argument("--pred-melody", action="store_true")
    h.add_argument("--bpm", type=float, default=120)
    h.add_argument("--seed", type=int, default=0)
    h.set_defaults(fn=cmd_harmonize)

    sv = sub.add_parser("serve", help="HTTP generation service")
    sv.add_argument("--port", type=int, default=8711)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--max-batch", type=int, default=16)
    sv.add_argument("--continuous", action="store_true",
                    help="serve /generate from the continuous-batching "
                         "engine (resident device batch, mid-flight joins)")
    sv.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    sv.set_defaults(fn=cmd_serve)

    t = sub.add_parser("tokenize", help="MIDI → token text")
    t.add_argument("--midi", required=True)
    t.add_argument("--genre", default=None)
    t.add_argument("--out", default=None)
    t.set_defaults(fn=cmd_tokenize)

    pp = sub.add_parser("preprocess", help="batch tokenize a MIDI corpus")
    pp.add_argument("--src", required=True)
    pp.add_argument("--out", required=True)
    pp.add_argument("--timeout", type=float, default=120)
    pp.set_defaults(fn=cmd_preprocess)

    tr = sub.add_parser("train", help="train the genre LM")
    tr.add_argument("--data", required=True, help="dir of cached .npy npencs")
    tr.add_argument("--ckpt", default="./checkpoints/lakh_genre_model")
    tr.add_argument("--epochs", type=int, default=3)
    tr.add_argument("--bs", type=int, default=16)
    tr.add_argument("--lr", type=float, default=5e-4)
    tr.add_argument("--limit", type=int, default=None)
    tr.add_argument("--small", action="store_true")
    tr.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    tr.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
