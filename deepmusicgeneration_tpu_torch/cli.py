"""Command-line interface of the PyTorch port.

    python -m deepmusicgeneration_tpu_torch generate --midi in.mid --genre jazz
    python -m deepmusicgeneration_tpu_torch serve --port 8711 [--continuous]
    python -m deepmusicgeneration_tpu_torch tokenize --midi in.mid

``generate`` (genre-conditioned continuation), ``serve`` (the HTTP
endpoint) and ``tokenize`` are ported; the other subcommands of the JAX
package are still to port (ROADMAP.md). ``--device cpu`` runs on the CPU;
the default is the CUDA card.
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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
