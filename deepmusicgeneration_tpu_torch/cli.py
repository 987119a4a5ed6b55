"""Command-line interface of the PyTorch port.

    python -m deepmusicgeneration_tpu_torch generate --midi in.mid --genre jazz

Only ``generate`` (genre-conditioned continuation) is ported; the other
subcommands of the JAX package are still to port (ROADMAP.md).
"""

from __future__ import annotations

import argparse


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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
