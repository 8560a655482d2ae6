"""Live web progress monitor (PyTorch port).

Counterpart of ``style_transfer_tpu/web.py``: an aiohttp server in a
background thread with its own event loop, the routes ``/`` (the page),
``/ws`` (status JSON and JPEG frames pushed to every connected websocket)
and ``/image`` (the latest frame), and a latest-event slot. The optimize
loop's progress callback only builds the status JSON and swaps the slot: on
the card ``ev.get_image()`` is a device-to-host copy, so it runs, with the
JPEG encode, in the server's executor and never on the loop's thread. A
slow encode drops intermediate frames (the slot holds the newest event).

aiohttp is imported here only; the CLI imports this module only under
``--web`` or ``--browser``.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Optional, Set

from aiohttp import web as aioweb

from style_transfer_tpu_torch.utils import imgio
from style_transfer_tpu_torch.utils.progress import ProgressEvent

_PAGE = """<!DOCTYPE html>
<html>
<head>
<title>style_transfer_tpu_torch</title>
<style>
  body { background: #111; color: #ddd; font-family: monospace; margin: 2em; }
  #status { margin-bottom: 0.5em; white-space: pre; }
  #spark { display: block; margin-bottom: 1em; border: 1px solid #333; }
  img { max-width: 95vw; max-height: 80vh; image-rendering: auto;
        border: 1px solid #333; }
</style>
</head>
<body>
<div id="status">connecting…</div>
<canvas id="spark" width="640" height="80"></canvas>
<img id="view" alt="in-progress stylization"/>
<script>
  const status = document.getElementById("status");
  const view = document.getElementById("view");
  const spark = document.getElementById("spark");
  const hist = [];           // sliding window: spread-based min/max throws
  const HIST_MAX = 2000;     // past ~100k args, and tab memory is bounded
  function draw() {
    const ctx = spark.getContext("2d");
    ctx.clearRect(0, 0, spark.width, spark.height);
    if (hist.length < 2) return;
    const logs = hist.map(v => Math.log(Math.max(v, 1e-12)));
    let lo = Infinity, hi = -Infinity;
    for (const v of logs) { if (v < lo) lo = v; if (v > hi) hi = v; }
    ctx.strokeStyle = "#6cf"; ctx.beginPath();
    logs.forEach((v, i) => {
      const x = i / (logs.length - 1) * (spark.width - 4) + 2;
      const y = spark.height - 4 - (hi > lo ? (v - lo) / (hi - lo) : 0.5) * (spark.height - 8);
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    });
    ctx.stroke();
  }
  function connect() {
    const ws = new WebSocket(`ws://${location.host}/ws`);
    ws.binaryType = "blob";
    ws.onmessage = (ev) => {
      if (typeof ev.data === "string") {
        const s = JSON.parse(ev.data);
        status.textContent =
          `scale ${s.scale}/${s.num_scales}  ${s.width}x${s.height}  ` +
          `iter ${s.iteration}/${s.total_iterations}  loss ${s.loss.toPrecision(6)}  ` +
          `(content ${s.content.toPrecision(4)}  style ${s.style.toPrecision(4)}  ` +
          `tv ${s.tv.toPrecision(4)})  ${s.its_per_sec.toFixed(1)} it/s` +
          (s.done ? "  — done" : "");
        for (const v of (s.loss_curve || [s.loss])) hist.push(v);
        if (hist.length > HIST_MAX) hist.splice(0, hist.length - HIST_MAX);
        draw();
      } else {
        const url = URL.createObjectURL(ev.data);
        view.onload = () => URL.revokeObjectURL(url);
        view.src = url;
      }
    };
    ws.onclose = () => { status.textContent += "  (disconnected)"; setTimeout(connect, 1000); };
  }
  connect();
</script>
</body>
</html>"""


class WebMonitor:
    """Background-thread aiohttp server streaming progress to browsers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8080, jpeg_quality: int = 85):
        self.host = host
        self.port = port
        self.jpeg_quality = jpeg_quality
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._sockets: Set[aioweb.WebSocketResponse] = set()
        self._frame: Optional[bytes] = None  # latest encoded JPEG
        self._status: Optional[str] = None  # latest status JSON
        self._pending = None  # latest unencoded (get_image, status) slot
        self._pending_lock = threading.Lock()  # guards the slot swap
        self._publishing = False  # single-consumer flag (loop thread only)
        self._idle = threading.Event()  # set when no publish is in flight
        self._idle.set()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="web-monitor", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("web monitor failed to start within 10s")

    def stop(self) -> None:
        if self._loop is not None:
            # flush the in-flight publish first so the final (done=True)
            # frame reaches clients before the loop goes down
            self._idle.wait(timeout=10)
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        app = aioweb.Application()
        app.router.add_get("/", self._index)
        app.router.add_get("/ws", self._ws)
        app.router.add_get("/image", self._image)
        runner = aioweb.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = aioweb.TCPSite(runner, self.host, self.port)
        loop.run_until_complete(site.start())
        self._started.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(runner.cleanup())
            loop.close()

    # ------------------------------------------------------------- handlers

    async def _index(self, request) -> aioweb.Response:
        return aioweb.Response(text=_PAGE, content_type="text/html")

    async def _image(self, request) -> aioweb.Response:
        if self._frame is None:
            return aioweb.Response(status=404, text="no frame yet")
        return aioweb.Response(body=self._frame, content_type="image/jpeg")

    async def _ws(self, request) -> aioweb.WebSocketResponse:
        ws = aioweb.WebSocketResponse()
        await ws.prepare(request)
        self._sockets.add(ws)
        try:
            # replay the latest state to a fresh client
            if self._status is not None:
                await ws.send_str(self._status)
            if self._frame is not None:
                await ws.send_bytes(self._frame)
            async for _ in ws:
                pass  # clients only listen
        finally:
            self._sockets.discard(ws)
        return ws

    async def _broadcast(self) -> None:
        dead = []
        for ws in list(self._sockets):
            try:
                if self._status is not None:
                    await ws.send_str(self._status)
                if self._frame is not None:
                    await ws.send_bytes(self._frame)
            except (ConnectionResetError, RuntimeError):
                dead.append(ws)
        for ws in dead:
            self._sockets.discard(ws)

    # ------------------------------------------------------------- callback

    def callback(self, ev: ProgressEvent) -> None:
        """Progress sink: publish the latest event, return immediately.

        The device fetch (``ev.get_image()``, a device-to-host copy of the
        image on the card) and the JPEG encode happen on the server side,
        never on the optimize loop's thread; this method only builds the
        status JSON and swaps a latest-event slot. If encoding falls behind,
        intermediate frames are dropped (the slot always holds the newest
        event).
        """
        h, w = ev.size
        status = json.dumps(
            {
                "scale": ev.scale_index + 1,
                "num_scales": ev.num_scales,
                "width": w,
                "height": h,
                "iteration": ev.iteration,
                "total_iterations": ev.total_iterations,
                "loss": ev.loss,
                "content": float(ev.losses["content"][-1]),
                "style": float(ev.losses["style"][-1]),
                "tv": float(ev.losses["tv"][-1]),
                # the chunk's full per-iteration total-loss curve feeds the
                # browser-side sparkline
                "loss_curve": [float(v) for v in ev.losses["loss"]],
                "its_per_sec": ev.its_per_sec,
                "done": ev.done,
            }
        )
        with self._pending_lock:
            self._pending = (ev.get_image, status)
            self._idle.clear()
        if self._loop is not None:
            asyncio.run_coroutine_threadsafe(self._publish(), self._loop)

    async def _publish(self) -> None:
        """Drain the latest-event slot: fetch + encode off-loop, broadcast.

        Single consumer: only one drain loop runs at a time (the flag is
        touched on the loop thread only), so frames always publish in event
        order — a slow encode can never overwrite a newer frame with an
        older one — and status/frame update together, atomically from the
        handlers' point of view. The slot swap is locked against the
        optimize-loop thread's store.
        """
        if self._publishing:
            return  # the active drain will pick the new slot value up
        self._publishing = True
        try:
            while True:
                with self._pending_lock:
                    pending, self._pending = self._pending, None
                if pending is None:
                    break
                get_image, status = pending
                frame = await self._loop.run_in_executor(
                    None,
                    lambda: imgio.encode_image(
                        get_image(), "JPEG", quality=self.jpeg_quality
                    ),
                )
                self._status = status
                self._frame = frame
                await self._broadcast()
        finally:
            self._publishing = False
            with self._pending_lock:
                if self._pending is None:
                    self._idle.set()
