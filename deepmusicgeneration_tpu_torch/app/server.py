"""HTTP serving endpoint (standard library only).

A JSON API over the generation services:

    POST /generate   {"midi_b64": ..., "genre": "jazz", "n_words": 256, ...}
                   → {"tokens": [...], "midi_b64": ..., "n_tokens": N}
    POST /tokenize   {"midi_b64": ...} → {"tokens": [...], "text": "...", "n_tokens": N}
    GET  /health     → {"ok": true}
    POST /remix, /harmonize → 501 until the multitask model is ported
                     (ROADMAP.md Queue 1, item 12)

Concurrent /generate requests ride the static coalescing
:class:`..tasks.serve.GenerationService`, or, with ``continuous=True``, the
continuous-batching :class:`..decode.continuous.ContinuousGenerationService`.
Run:

    python -m deepmusicgeneration_tpu_torch serve --port 8711 [--continuous] [--device cpu]
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..codec.item import MusicItem
from ..vocab import BOS, MusicVocab, genre_prefix_token


class NotPorted(Exception):
    """A route whose model is not ported yet (answered with 501)."""


class MusicServer:
    def __init__(self, genre_learner=None, max_batch: int = 16,
                 continuous: bool = False, device=None):
        """``genre_learner``: a loaded ``MusicLearner``, or None to load
        ``createGenreContinuationModel(device=device)`` on the first
        /generate. ``continuous=True`` serves /generate from the
        continuous-batching engine: requests join a resident device batch
        within one chunk of arriving, requests with different sampling
        settings share it, and early-stopping rows free their lane at once."""
        self.vocab = MusicVocab.create()
        self._genre = genre_learner
        self._service = None
        # RLock: service() holds it while calling genre(), which locks again
        self._lock = threading.RLock()
        self.max_batch = max_batch
        self.continuous = continuous
        self.device = device

    # lazy model loading so /health answers at once
    def genre(self):
        with self._lock:
            if self._genre is None:
                from .app_utils import createGenreContinuationModel
                self._genre = createGenreContinuationModel(device=self.device)
            return self._genre

    def service(self):
        # the same lock as genre(): two concurrent first /generate requests
        # must not build two services
        with self._lock:
            if self._service is None:
                if self.continuous:
                    from ..decode.continuous import ContinuousGenerationService
                    self._service = ContinuousGenerationService(
                        self.genre(), n_slots=self.max_batch)
                else:
                    from ..tasks.serve import GenerationService
                    self._service = GenerationService(self.genre(),
                                                      max_batch=self.max_batch)
            return self._service

    # -- handlers ------------------------------------------------------------
    def handle_tokenize(self, req: dict) -> dict:
        midi = base64.b64decode(req["midi_b64"])
        item = MusicItem.from_file(midi, self.vocab, genre=req.get("genre"))
        return {"tokens": item.data.tolist(), "text": item.to_text(),
                "n_tokens": len(item)}

    def handle_generate(self, req: dict) -> dict:
        midi = base64.b64decode(req["midi_b64"])
        item = MusicItem.from_file(midi, self.vocab)
        seed = item.trim_to_beat(float(req.get("cutoff_beat", 32)))
        genre = req.get("genre")
        if genre:
            seed = seed.set_genre(genre if genre_prefix_token(genre) != BOS else None)
        seed = seed.remove_eos()
        fut = self.service().submit(
            seed.data,
            n_words=int(req.get("n_words", 256)),
            temperatures=tuple(req.get("temperatures", (1.8, 1.8, 1.0))),
            top_k=int(req.get("top_k", 30)),
            top_p=float(req.get("top_p", 0.65)),
            min_bars=int(req.get("min_bars", 12)),
            greedy=bool(req.get("greedy", False)),
            seed=int(req.get("seed", 0)))
        new = fut.result(timeout=float(req.get("timeout_s", 600)))
        full = seed.append(MusicItem(np.asarray(new, np.int64), self.vocab))
        return {"tokens": np.asarray(new).tolist(), "n_tokens": int(len(new)),
                "midi_b64": base64.b64encode(
                    full.to_midi_bytes(bpm=float(req.get("bpm", 120)))).decode()}

    def handle_multitask(self, req: dict) -> dict:
        raise NotPorted("remix and harmonize need the multitask model, which is "
                        "not ported yet (ROADMAP.md Queue 1, item 12)")

    def close(self):
        if self._service is not None:
            self._service.close()


def make_handler(server: MusicServer):
    routes = {
        "/tokenize": server.handle_tokenize,
        "/generate": server.handle_generate,
        "/remix": server.handle_multitask,
        "/harmonize": server.handle_multitask,
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            fn = routes.get(self.path)
            if fn is None:
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                self._send(200, fn(req))
            except KeyError as e:
                self._send(400, {"error": f"missing field {e}"})
            except NotPorted as e:
                self._send(501, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": repr(e)})

    return Handler


def serve(port: int = 8711, host: str = "127.0.0.1", max_batch: int = 16,
          continuous: bool = False, device=None):
    """Serve until interrupted. The JAX package raises the thread stack to
    256 MB here for XLA:CPU compiles on request threads; torch compiles
    nothing on them, so the default stack is kept."""
    server = MusicServer(max_batch=max_batch, continuous=continuous, device=device)
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    print(f"serving on http://{host}:{httpd.server_address[1]} "
          f"(/health /tokenize /generate; /remix /harmonize answer 501)")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()
