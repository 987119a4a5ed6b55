"""The port's HTTP surface on the CPU (``app/server.py``, ``app/app_utils.py``,
``cli.py``): a real round trip on an ephemeral port with the demo
checkpoint. /generate over the static and the continuous service returns
the tokens of a direct call of the same request; the multitask routes
answer 501 until that model is ported."""

import base64
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from deepmusicgeneration_tpu.train.synthcorpus import generate_song
from deepmusicgeneration_tpu_torch import cli
from deepmusicgeneration_tpu_torch.app import app_utils
from deepmusicgeneration_tpu_torch.app.server import MusicServer, make_handler
from deepmusicgeneration_tpu_torch.codec.item import MusicItem
from deepmusicgeneration_tpu_torch.decode.continuous import ContinuousEngine
from deepmusicgeneration_tpu_torch.train.learner import MusicLearner
from deepmusicgeneration_tpu_torch.vocab import MusicVocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "demo_genre_model")


@pytest.fixture(scope="module")
def learner():
    return MusicLearner.load(DEMO, device="cpu")


@pytest.fixture(scope="module")
def midi(learner):
    return MusicItem.from_npenc(generate_song("jazz", 3), learner.vocab).to_midi_bytes()


def _start(server):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module", params=[False, True], ids=["static", "continuous"])
def http(request, learner):
    server = MusicServer(genre_learner=learner, max_batch=4, continuous=request.param)
    httpd, url = _start(server)
    yield url, server
    httpd.shutdown()
    server.close()


def _post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _seed(learner, midi, req):
    return MusicItem.from_file(midi, learner.vocab).trim_to_beat(req["cutoff_beat"]) \
        .set_genre(req["genre"]).remove_eos()


def test_health_and_tokenize(http, midi, learner):
    url, _ = http
    with urllib.request.urlopen(url + "/health", timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True}
    code, out = _post(url, "/tokenize", {"midi_b64": base64.b64encode(midi).decode()})
    assert code == 200
    want = MusicItem.from_file(midi, learner.vocab)
    assert out["tokens"] == want.data.tolist() and out["n_tokens"] == len(want)
    assert out["text"].startswith("xxbos xxpad")


@pytest.mark.parametrize("temps", [[1.4, 1.4, 1.0], [1.2, 1.6]], ids=["three", "pair"])
def test_generate_equals_a_direct_call(http, midi, learner, temps):
    """/generate returns the tokens of the same request made directly: the
    static service's engine call, or a fresh continuous engine (a row's
    stream does not depend on its batch). A pair of temperatures is the
    3-tuple (t_note, t_dur, t_dur)."""
    url, server = http
    req = {"midi_b64": base64.b64encode(midi).decode(), "genre": "jazz", "n_words": 20,
           "cutoff_beat": 8, "temperatures": temps, "top_k": 12, "seed": 3}
    code, out = _post(url, "/generate", req)
    assert code == 200, out
    seed = _seed(learner, midi, req)
    kw = dict(n_words=20, temperatures=tuple(temps), top_k=12, top_p=0.65,
              min_bars=12, greedy=False, seed=3)
    if server.continuous:
        want = ContinuousEngine(learner.params, learner.cfg, learner.vocab, n_slots=4,
                                device="cpu").generate(seed.data, **kw)
    else:
        toks, lengths = learner.engine.generate_batch([seed.data], **kw)
        want = toks[0][: lengths[0]]
    assert out["tokens"] == np.asarray(want).tolist() and out["n_tokens"] == len(want)
    back = MusicItem.from_file(base64.b64decode(out["midi_b64"]), learner.vocab)
    assert back.data[0] == learner.vocab.bos_idx


def test_errors(http, midi):
    url, _ = http
    assert _post(url, "/generate", {})[0] == 400
    code, out = _post(url, "/generate", {"n_words": 4})
    assert code == 400 and "midi_b64" in out["error"]
    assert _post(url, "/nope", {})[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404
    for route in ("/remix", "/harmonize"):
        code, out = _post(url, route, {"midi_b64": base64.b64encode(midi).decode()})
        assert code == 501 and "multitask" in out["error"]


def test_genre_factory_chain(tmp_path):
    """A missing checkpoint falls back to the committed ones; the learner
    lands on the device asked for."""
    got = app_utils.createGenreContinuationModel(ckpt_path=str(tmp_path / "none"),
                                                 device="cpu")
    assert got.cfg.n_layers == 8 and got.device == "cpu"      # synth_genre_model
    demo = app_utils.createGenreContinuationModel(encode_position=True,
                                                  ckpt_path=str(tmp_path / "none"),
                                                  device="cpu")
    assert demo.cfg.n_layers == 4                             # demo_genre_model


def test_cli_tokenize(tmp_path, midi, capsys):
    path = tmp_path / "in.mid"
    path.write_bytes(midi)
    cli.main(["tokenize", "--midi", str(path)])
    text = capsys.readouterr().out.strip()
    assert text == MusicItem.from_file(str(path), MusicVocab.create()).to_text()
