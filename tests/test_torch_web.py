"""The port's web monitor (``style_transfer_tpu_torch.web``): the cases of
``tests/test_web.py`` against its ``WebMonitor`` and ``ProgressEvent``."""

import json
import socket
import time
import urllib.request

import numpy as np
import pytest

from style_transfer_tpu_torch.utils.progress import ProgressEvent
from style_transfer_tpu_torch.web import WebMonitor


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _event(img, it=5):
    return ProgressEvent(
        scale_index=0,
        num_scales=2,
        size=img.shape[:2],
        iteration=it,
        total_iterations=10,
        losses={
            "loss": np.asarray([1.2, 1.0]),
            "content": np.asarray([0.5, 0.4]),
            "style": np.asarray([0.2, 0.1]),
            "tv": np.asarray([0.05, 0.04]),
        },
        its_per_sec=3.0,
        get_image=lambda: img,
    )


def _wait_for_frame(monitor, timeout=5.0):
    """Frame encoding is asynchronous (server-side); wait until published."""
    deadline = time.time() + timeout
    while monitor._frame is None and time.time() < deadline:
        time.sleep(0.01)
    assert monitor._frame is not None, "no frame published within timeout"


@pytest.fixture()
def monitor():
    m = WebMonitor(port=_free_port())
    m.start()
    yield m
    m.stop()


def test_index_page(monitor):
    with urllib.request.urlopen(f"http://127.0.0.1:{monitor.port}/") as r:
        body = r.read().decode()
    assert "WebSocket" in body and r.status == 200


def test_image_endpoint_404_then_frame(monitor):
    url = f"http://127.0.0.1:{monitor.port}/image"
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(url)
    assert exc.value.code == 404

    img = np.random.RandomState(0).rand(16, 16, 3).astype(np.float32)
    monitor.callback(_event(img))
    _wait_for_frame(monitor)
    with urllib.request.urlopen(url) as r:
        data = r.read()
    assert data[:2] == b"\xff\xd8"  # JPEG


def test_websocket_stream(monitor):
    import asyncio

    import websockets

    img = np.random.RandomState(1).rand(8, 8, 3).astype(np.float32)
    monitor.callback(_event(img, it=7))
    _wait_for_frame(monitor)

    async def client():
        uri = f"ws://127.0.0.1:{monitor.port}/ws"
        async with websockets.connect(uri) as ws:
            first = await asyncio.wait_for(ws.recv(), timeout=5)
            second = await asyncio.wait_for(ws.recv(), timeout=5)
            return first, second

    first, second = asyncio.new_event_loop().run_until_complete(client())
    status = json.loads(first)
    assert status["iteration"] == 7 and status["num_scales"] == 2
    assert bytes(second)[:2] == b"\xff\xd8"


def test_status_payload_carries_loss_terms(monitor):
    img = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    monitor.callback(_event(img))
    _wait_for_frame(monitor)
    s = json.loads(monitor._status)
    assert s["loss"] == 1.0 and s["content"] == 0.4 and s["style"] == 0.1
    assert s["loss_curve"] == [1.2, 1.0]


def test_callback_never_blocks_on_device_fetch(monitor):
    """The progress callback must not fetch/encode on the caller's (hot-loop)
    thread: get_image runs on the server side (on the card it is a
    device-to-host copy)."""
    import threading

    caller = threading.current_thread()
    fetch_threads = []
    img = np.random.RandomState(2).rand(8, 8, 3).astype(np.float32)

    def get_image():
        fetch_threads.append(threading.current_thread())
        return img

    ev = _event(img)
    ev.get_image = get_image
    monitor.callback(ev)
    deadline = time.time() + 5
    while monitor._frame is None and time.time() < deadline:
        time.sleep(0.01)
    assert monitor._frame is not None and monitor._frame[:2] == b"\xff\xd8"
    assert fetch_threads and all(t is not caller for t in fetch_threads)


def test_frames_drop_to_latest(monitor):
    """Back-to-back callbacks collapse to the newest frame (latest-slot)."""
    imgs = [np.full((8, 8, 3), v, np.float32) for v in (0.1, 0.5, 0.9)]
    for i, im in enumerate(imgs):
        monitor.callback(_event(im, it=i + 1))
    deadline = time.time() + 5
    while time.time() < deadline:
        if monitor._status and json.loads(monitor._status)["iteration"] == 3:
            if monitor._pending is None and monitor._frame is not None:
                break
        time.sleep(0.01)
    assert json.loads(monitor._status)["iteration"] == 3


def test_stop_flushes_final_frame():
    """stop() right after the last callback must still publish that frame —
    the done=True event may be in flight when the CLI tears the monitor
    down (single-consumer drain + idle flush in WebMonitor)."""
    m = WebMonitor(port=_free_port())
    m.start()
    try:
        img = np.random.RandomState(1).rand(16, 16, 3).astype(np.float32)
        slow_fetch_done = []

        def slow_get_image():
            time.sleep(0.3)  # simulate a large device fetch
            slow_fetch_done.append(True)
            return img

        ev = _event(img, it=10)
        ev.get_image = slow_get_image
        ev.done = True
        m.callback(ev)
    finally:
        m.stop()  # must wait for the in-flight publish, not race it
    assert slow_fetch_done, "final frame fetch never ran"
    assert m._frame is not None and m._frame[:2] == b"\xff\xd8"
    assert json.loads(m._status)["done"] is True


def test_out_of_order_encodes_never_regress(monitor):
    """A newer event always wins the published frame/status even when an
    older event's image fetch is slower (in-order single-consumer drain)."""
    imgs = {
        1: np.zeros((16, 16, 3), np.float32),
        2: np.ones((16, 16, 3), np.float32),
    }

    def slow_one():
        time.sleep(0.25)
        return imgs[1]

    ev1 = _event(imgs[1], it=1)
    ev1.get_image = slow_one
    ev2 = _event(imgs[2], it=2)
    m = monitor
    m.callback(ev1)
    m.callback(ev2)
    deadline = time.time() + 5
    while time.time() < deadline:
        if m._status is not None and json.loads(m._status)["iteration"] == 2 and not m._publishing:
            break
        time.sleep(0.02)
    assert json.loads(m._status)["iteration"] == 2
    # the final published frame must be event 2's (all-white) image
    from io import BytesIO
    from PIL import Image
    arr = np.asarray(Image.open(BytesIO(m._frame)))
    assert arr.mean() > 200, f"stale frame published (mean {arr.mean():.1f})"
