"""The port's live HTTP server (runtime/live.py) against the JAX package's,
on the CPU, over loopback.

- The events of tests/test_live.py:19-28 posted to the port's server and
  to the JAX package's at 64x64: the same status for every event (200 for a
  rendered frame, 204 while frozen), the same X-Frame-Index, X-Camera
  within 1e-6; the port's wire frames bit for bit an offline port
  FrameLoop's (the plain renderer) quantized by to_srgb_u8, and within
  1 LSB of the JAX server's (its jnp FrameLoop): the renderers' image
  tolerance, rtol 1e-3 / atol 2e-3, is under 0.77 LSB on values in [0, 1].
- /state with the JAX server's keys and values, /frame (the last frame),
  the page, 404 for other paths, 400 for a malformed body.
- A quit event gives 204 with X-Quit: true; a frozen one 204 with false;
  /frame before any frame 204.
- The server's quantizer on CPU tensors bit for bit to_srgb_u8 (the port's
  and the JAX package's) at every k/255, at (k + 0.5)/255 and three ulps
  either side, and at negative values, values above 1 and +-inf.

chip_smoke.py phase 21 drives the server at 1920x1088 on the card.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raytracing_engine_tpu.config import RenderConfig as JRenderConfig
from raytracing_engine_tpu.runtime import FrameLoop as JFrameLoop
from raytracing_engine_tpu.runtime import LiveFrameServer as JLiveFrameServer
from raytracing_engine_tpu.scene import default_scene as jax_default_scene
from raytracing_engine_tpu.utils.image import to_srgb_u8 as jax_to_srgb_u8

import raytracing_engine_tpu_torch as rtt
from raytracing_engine_tpu_torch.runtime import FrameLoop, InputEvent, LiveFrameServer
from raytracing_engine_tpu_torch.runtime.live import to_u8
from raytracing_engine_tpu_torch.utils.image import encode_png, read_png, to_srgb_u8

torch.set_num_threads(1)

# tests/test_live.py:19-28
EVENTS = [
    dict(move=(0, 1, 0), dt=0.05),
    dict(move=(1, 0, 0), rot=(1, 0), dt=0.05),
    dict(cursor=(12.0, -4.0), dt=0.05),
    dict(move=(0, 0, 1), rot=(0, -1), dt=0.05),
    dict(focus=False),           # freeze: no frame
    dict(move=(0, 1, 0)),        # frozen: still no frame
    dict(focus=True),
    dict(move=(0, 1, 0), dt=0.05),
]
SIZE = 64
U8_LSB = 1  # port vs JAX: the image tolerance, under 0.77 LSB before rounding


def request(url, path, body=None):
    """(status, body bytes, headers) of a GET (body None) or POST."""
    req = urllib.request.Request(url + path, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def post(url, event):
    return request(url, "/step", json.dumps(event).encode())


def decode(data, tmp_path, name):
    p = tmp_path / name
    p.write_bytes(data)
    return read_png(str(p))


@pytest.fixture(scope="module")
def servers():
    port = LiveFrameServer(FrameLoop(rtt.RenderConfig(SIZE, SIZE), rtt.default_scene("cpu")))
    jax = JLiveFrameServer(JFrameLoop(JRenderConfig(width=SIZE, height=SIZE),
                                      jax_default_scene()))
    yield port, jax
    port.close()
    jax.close()


@pytest.fixture(scope="module")
def driven(servers):
    """EVENTS posted to both servers: [(port reply, JAX reply)] per event."""
    port, jax = servers
    return [(post(port.url, ev), post(jax.url, ev)) for ev in EVENTS]


def test_wire_equals_offline_and_jax(driven, tmp_path):
    loop = FrameLoop(rtt.RenderConfig(SIZE, SIZE), rtt.default_scene("cpu"))
    offline, prev = [], None
    for ev in EVENTS:
        img = loop.step(InputEvent(**ev))
        if img is not None and img is not prev:
            offline.append(to_srgb_u8(img.numpy()))
        prev = img
    wire = []
    for k, ((st, body, hdrs), (jst, jbody, jhdrs)) in enumerate(driven):
        assert st == jst, f"event {k}: status {st} vs JAX {jst}"
        if st == 204:
            assert body == b"" and hdrs["X-Quit"] == jhdrs["X-Quit"] == "false"
            continue
        assert st == 200 and hdrs["Content-Type"] == "image/png"
        assert hdrs["X-Frame-Index"] == jhdrs["X-Frame-Index"] == str(len(wire))
        cam, jcam = json.loads(hdrs["X-Camera"]), json.loads(jhdrs["X-Camera"])
        assert cam.keys() == jcam.keys()
        for key in cam:
            np.testing.assert_allclose(cam[key], jcam[key], rtol=1e-6, atol=1e-6)
        frame = decode(body, tmp_path, f"port{k}.png")
        want = decode(jbody, tmp_path, f"jax{k}.png")
        assert frame.shape == (SIZE, SIZE, 3) and frame.max() > 0
        lsb = np.abs(frame.astype(int) - want.astype(int)).max()
        assert lsb <= U8_LSB, f"event {k}: {lsb} LSB from the JAX server's frame"
        wire.append(frame)
    assert len(wire) == len(offline) == 6
    for k, (a, b) in enumerate(zip(wire, offline)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    # the PNG is the JAX server's encoding of the same u8 plane (zlib level 1)
    assert driven[-1][0][1] == encode_png(offline[-1], level=1)


def test_state_frame_page_and_errors(servers, driven, tmp_path):
    port, jax = servers
    (st, body, _), (jst, jbody, _) = (request(s.url, "/state") for s in (port, jax))
    assert st == jst == 200
    state, jstate = json.loads(body), json.loads(jbody)
    assert state.keys() == jstate.keys() == {"frame", "camera", "quit", "frozen", "size"}
    assert state["camera"].keys() == jstate["camera"].keys() == {"position", "rotation"}
    for key in ("frame", "quit", "frozen", "size"):
        assert state[key] == jstate[key], key
    assert state["frame"] == 5 and state["size"] == [SIZE, SIZE]
    for key in ("position", "rotation"):
        np.testing.assert_allclose(state["camera"][key], jstate["camera"][key], atol=1e-6)

    st, body, hdrs = request(port.url, "/frame")
    assert st == 200 and hdrs["X-Frame-Index"] == "5"
    np.testing.assert_array_equal(decode(body, tmp_path, "last.png"),
                                  decode(driven[-1][0][1], tmp_path, "step.png"))
    st, body, hdrs = request(port.url, "/")
    assert st == 200 and hdrs["Content-Type"] == "text/html"
    assert body == request(jax.url, "/")[1] and b"fetch('/step'" in body
    for path, payload in (("/nope", None), ("/nope", b"{}"), ("/stateX", None)):
        assert request(port.url, path, payload)[0] == 404, path
    for bad in (b"{not json", b'{"move": 5}', b'{"dt": "fast"}'):
        st, body, _ = request(port.url, "/step", bad)
        assert st == 400 and body.startswith(b"bad event:"), bad
        assert st == request(jax.url, "/step", bad)[0]
    assert json.loads(request(port.url, "/state")[1])["frame"] == 5  # nothing rendered


def test_quit_and_frozen_give_204():
    srv = LiveFrameServer(FrameLoop(rtt.RenderConfig(32, 32), rtt.default_scene("cpu")))
    try:
        assert request(srv.url, "/frame")[0] == 204  # no frame yet
        st, _, hdrs = post(srv.url, dict(focus=False))
        assert st == 204 and hdrs["X-Quit"] == "false"
        st, _, hdrs = post(srv.url, dict(focus=True, move=(0, 1, 0)))
        assert st == 200 and hdrs["X-Frame-Index"] == "0"
        st, _, hdrs = post(srv.url, dict(quit=True))
        assert st == 204 and hdrs["X-Quit"] == "true"
        st, _, hdrs = post(srv.url, dict(move=(0, 1, 0)))
        assert st == 204 and hdrs["X-Quit"] == "true"
        assert srv.state()["quit"] and srv.state()["frame"] == 0
    finally:
        srv.close()


def test_quantizer_matches_to_srgb_u8():
    k = np.arange(256, dtype=np.float64)
    half = ((k + 0.5) / 255.0).astype(np.float32)
    up, down, around = half, half, []
    for _ in range(3):
        up = np.nextafter(up, np.float32(2.0))
        down = np.nextafter(down, np.float32(-2.0))
        around += [up, down]
    special = np.array([-0.0, -1e-30, -0.5, -1.0, -3e38, 1.0, 1.0000001, 1.5, 255.0, 3e38,
                        np.inf, -np.inf, 2.0 ** -149, 0.5 / 255.0], np.float32)
    x = np.concatenate([(k / 255.0).astype(np.float32), half, *around, special])
    # some products x * 255 land exactly on a rounding tie: round half to even
    unit = x[(x >= 0.0) & (x <= 1.0)]
    assert ((unit * np.float32(255.0)) % 1.0 == 0.5).sum() >= 50
    img = np.resize(x, (x.size + 2) // 3 * 3).reshape(-1, 1, 3)
    got = to_u8(torch.from_numpy(img))
    assert got.dtype == torch.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got.numpy(), to_srgb_u8(img))
    np.testing.assert_array_equal(got.numpy(), jax_to_srgb_u8(img))
    assert set(np.unique(got.numpy()).tolist()) == set(range(256))
