"""The pipelined chunk loop of ``StyleTransfer.stylize`` (``api.py``): two
chunks queued beyond the one being processed, fetches bound to their own
chunk, early-stop rollback, and a step that reads nothing from the device.

Port against port, bit for bit: pipelined and sequential runs of the same
configuration give the same image, events, losses and ``get_image()`` (the
port's form of ``tests/test_api.py:306-355``). Port against JAX: both
packages' pipelined loops on the JAX fixture weights, fp32 on the CPU, with
an early stop: the same event stream, losses at rtol 1e-4. Spies show the
dispatch order, the host reads of a chunk and what exists only on the card.
"""

import threading

import numpy as np
import pytest
import torch

from style_transfer_tpu import cli as jcli
from style_transfer_tpu.api import StyleTransfer as JStyleTransfer
from style_transfer_tpu.api import StylizeConfig as JStylizeConfig
from style_transfer_tpu.optim import OptimizerSpec as JOptimizerSpec
from style_transfer_tpu_torch import StyleTransfer, StylizeConfig, api, cli, linesearch
from style_transfer_tpu_torch.models.weights import from_numpy_params
from style_transfer_tpu_torch.optim import OptimizerSpec
from style_transfer_tpu_torch.utils import imgio

torch.set_num_threads(2)

TERMS = ("loss", "content", "style", "tv")


@pytest.fixture(scope="module")
def packages(tiny_params):
    jparams, mean, std = tiny_params
    jst = JStyleTransfer(jparams, mean=mean, std=std)
    pst = StyleTransfer(from_numpy_params(jparams), mean=mean, std=std, device="cpu")
    return jst, pst


@pytest.fixture(scope="module")
def images():
    r = np.random.RandomState(7)
    content, style = r.rand(64, 48, 3).astype(np.float32), r.rand(48, 64, 3).astype(np.float32)
    init = np.clip(content + 0.1 * r.randn(*content.shape), 0, 1).astype(np.float32)
    return content, style, init


def _cfg(optimizer="adam", **kw):
    base = dict(size=64, min_scale=32, iterations=(9,), chunk_size=3,
                content_layers=("conv4_2",), style_layers=("conv1_1", "conv2_1", "conv3_1"),
                optimizer=OptimizerSpec(optimizer))
    base.update(kw)
    return StylizeConfig(**base)


class _Recorder:
    """A callback that keeps each event's coordinates, losses and image
    (fetched inside the callback, from another thread as the web monitor
    does), and how many chunks the loop had queued when it ran."""

    def __init__(self, st):
        self.events, self.images, self.queued_at = [], [], []
        self.dispatched = []
        real = st._dispatch_chunk

        def dispatch(step, image, ema, opt_state, **kw):
            self.dispatched.append((tuple(image.shape[1:3]), kw["done_iters"] + kw["n"]))
            return real(step, image, ema, opt_state, **kw)

        self.dispatch = dispatch

    def __call__(self, ev):
        self.queued_at.append(len(self.dispatched))
        self.events.append(ev)
        out = []
        t = threading.Thread(target=lambda: out.append(ev.get_image()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        self.images.append(out[0])


def _run(st, content, style, init, cfg, monkeypatch=None, **kw):
    rec = _Recorder(st)
    if monkeypatch is not None:
        monkeypatch.setattr(st, "_dispatch_chunk", rec.dispatch)
    out = st.stylize(content, style, cfg, callback=rec, init_image=init, **kw)
    if monkeypatch is not None:
        monkeypatch.undo()
    return out, rec


CASES = {
    "plain": dict(),
    "avg_decay": dict(avg_decay=0.9),
    # stop_tol=1 counts every chunk as a stall: each scale stops at its
    # third chunk, with its fourth and fifth queued
    "early_stop": dict(iterations=(15,), stop_tol=1.0, stop_patience=2),
    "lbfgs": dict(optimizer="lbfgs", iterations=(6,), chunk_size=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_matches_sequential_bit_for_bit(packages, images, case):
    _, pst = packages
    content, style, init = images
    runs = {p: _run(pst, content, style, init, _cfg(pipeline_chunks=p, **CASES[case]))
            for p in (False, True)}
    (seq, a), (pipe, b) = runs[False], runs[True]
    np.testing.assert_array_equal(seq, pipe)
    assert [(e.scale_index, e.iteration, e.done) for e in a.events] == \
        [(e.scale_index, e.iteration, e.done) for e in b.events]
    assert b.events[-1].done
    for ea, eb, ia, ib in zip(a.events, b.events, a.images, b.images):
        assert list(ea.losses) == list(eb.losses) == list(TERMS)
        for k in TERMS:
            np.testing.assert_array_equal(ea.losses[k], eb.losses[k])
        np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("avg_decay", [0.0, 0.9])
def test_resume_from_a_state_taken_with_chunks_in_flight(packages, images, monkeypatch,
                                                         avg_decay):
    """``get_state()`` inside the callback of chunk 1 of 6, while chunks 2
    and 3 are queued, resumes to the uninterrupted run's bits."""
    _, pst = packages
    content, style, init = images
    cfg = _cfg(size=48, min_scale=48, iterations=(18,), avg_decay=avg_decay,
               pipeline_chunks=True)
    states, queued = [], []
    rec = _Recorder(pst)
    monkeypatch.setattr(pst, "_dispatch_chunk", rec.dispatch)

    def callback(ev):
        if ev.iteration == 3:
            queued.append(len(rec.dispatched))
            states.append(ev.get_state())

    full = pst.stylize(content, style, cfg, callback=callback, init_image=init)
    monkeypatch.undo()
    # chunks 0, 1 and 2 queued (two beyond the one processed), and chunk 3
    # too if the loop went on while the callback ran on its worker thread
    assert len(queued) == 1 and queued[0] in (3, 4)
    assert int(states[0]["iteration"]) == 3 and ("ema" in states[0]) == (avg_decay > 0)
    resumed = pst.stylize(content, style, cfg, resume_state=states[0])
    np.testing.assert_array_equal(resumed, full)


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_pipelined_run_matches_the_jax_pipelined_run(packages, images, optimizer):
    """Both packages pipelined, with an early stop in every scale: the event
    stream exactly, the losses at rtol 1e-4, the images at the API parity
    tests' limits (L-BFGS's pixels at 1e-4, ``test_torch_api_lbfgs.py``;
    Adam's by their mean absolute difference, ``test_torch_cli.py``)."""
    jst, pst = packages
    content, style, init = images
    kw = dict(size=64, min_scale=32, iterations=(10,), chunk_size=2, stop_tol=1.0,
              stop_patience=2, content_layers=("conv2_2",), style_layers=("conv1_1", "conv2_1"))
    jev, pev = [], []
    jout = jst.stylize(content, style, JStylizeConfig(
        warm_compile=False, use_fused=False, pipeline_chunks=True,
        optimizer=JOptimizerSpec(optimizer), **kw), callback=jev.append, init_image=init)
    pout = pst.stylize(content, style, StylizeConfig(
        pipeline_chunks=True, optimizer=OptimizerSpec(optimizer), **kw),
        callback=pev.append, init_image=init)
    coords = [(e.scale_index, e.iteration, e.done) for e in pev]
    assert coords == [(e.scale_index, e.iteration, e.done) for e in jev]
    assert coords == [(0, 2, False), (0, 4, False), (0, 6, False),
                      (1, 2, False), (1, 4, False), (1, 6, True)]
    for pe, je in zip(pev, jev):
        for k in TERMS:
            np.testing.assert_allclose(pe.losses[k], je.losses[k], rtol=1e-4, atol=1e-9)
    assert pout.shape == jout.shape == (64, 48, 3)
    if optimizer == "lbfgs":
        np.testing.assert_allclose(pout, jout, atol=1e-4)
    else:
        assert float(np.abs(pout - jout).mean()) < 1e-2


@pytest.mark.parametrize("pipelined", [False, True])
def test_dispatch_order(packages, images, monkeypatch, pipelined):
    """When the callback for chunk k runs, the pipelined loop has queued
    chunk min(k + 2, last) (and, with the callback on its worker thread, at
    most k + 3), the sequential loop chunk k alone."""
    _, pst = packages
    content, style, init = images
    _, rec = _run(pst, content, style, init,
                  _cfg(iterations=(15,), pipeline_chunks=pipelined), monkeypatch)
    assert len(rec.events) == len(rec.dispatched) == 10
    for k, (ev, queued) in enumerate(zip(rec.events, rec.queued_at)):
        last = 4 if ev.scale_index == 0 else 9  # five chunks a scale
        assert rec.dispatched[k] == (ev.size, ev.iteration)
        if not pipelined:
            assert queued - 1 == k
        elif k < last:
            assert min(k + 2, last) <= queued - 1 <= min(k + 3, last)


def test_no_event_from_a_speculative_chunk(packages, images, monkeypatch):
    """An early stop at chunk k drops the chunks queued after it: the scale's
    events end at k, and the next scale starts from chunk k's image."""
    _, pst = packages
    content, style, init = images
    cfg = _cfg(iterations=(15,), stop_tol=1.0, stop_patience=2, pipeline_chunks=True)
    pipe, rec = _run(pst, content, style, init, cfg, monkeypatch)
    assert [(e.scale_index, e.iteration) for e in rec.events] == \
        [(0, 3), (0, 6), (0, 9), (1, 3), (1, 6), (1, 9)]
    # chunks 12 and 15 of each scale were queued and dropped
    assert [it for _, it in rec.dispatched] == [3, 6, 9, 12, 15] * 2
    seq, _ = _run(pst, content, style, init, _cfg(iterations=(15,), stop_tol=1.0,
                                                  stop_patience=2, pipeline_chunks=False))
    np.testing.assert_array_equal(seq, pipe)


_READS = [(torch.Tensor, name) for name in
          ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__")]
_COPIES = [(torch, "as_tensor"), (torch, "tensor")]


class _HostSpy:
    """Counts host reads and tensors made from host data while active."""

    def __init__(self, monkeypatch):
        self.reads, self.copies, self.active = [], [], False
        for owner, name in _READS + _COPIES:
            real = getattr(owner, name)
            log = self.reads if (owner, name) in _READS else self.copies

            def spy(*a, _real=real, _name=name, _log=log, **kw):
                if self.active:
                    _log.append(_name)
                return _real(*a, **kw)

            monkeypatch.setattr(owner, name, spy)


@pytest.mark.parametrize("kw", [dict(), dict(avg_decay=0.9), dict(remat=True),
                                dict(use_fused=False), dict(fused_block1=True)],
                         ids=["chain", "avg_decay", "remat", "unfused", "fused_block1"])
def test_an_adam_chunk_reads_the_host_once(packages, images, monkeypatch, kw):
    """From the chunk's first step to the start of its loss fetch nothing
    reads the device and nothing is made from host data (the preprocessing
    constants included); the one read is the fetch, once a chunk."""
    _, pst = packages
    content, style, init = images
    spy = _HostSpy(monkeypatch)
    fetches, real_fetch, real_dispatch = [], api._fetch_losses, pst._dispatch_chunk
    monkeypatch.setattr(api, "_fetch_losses", lambda rows: fetches.append(1) or real_fetch(rows))

    def dispatch(*a, **k):
        spy.active = True
        try:
            return real_dispatch(*a, **k)
        finally:
            spy.active = False

    monkeypatch.setattr(pst, "_dispatch_chunk", dispatch)
    events = []
    pst.stylize(content, style, _cfg(**kw), callback=events.append, init_image=init)
    assert len(events) == 6 and len(fetches) == 6
    assert spy.reads == [] and spy.copies == []


def test_an_lbfgs_chunk_reads_the_host_once_per_linesearch_step(packages, images, monkeypatch):
    _, pst = packages
    content, style, init = images
    spy = _HostSpy(monkeypatch)
    real = pst._dispatch_chunk

    def dispatch(*a, **k):
        spy.active = True
        try:
            return real(*a, **k)
        finally:
            spy.active = False

    monkeypatch.setattr(pst, "_dispatch_chunk", dispatch)
    reads0 = linesearch.host_reads.n
    pst.stylize(content, style, _cfg("lbfgs", iterations=(4,), chunk_size=2), init_image=init)
    assert linesearch.host_reads.n > reads0
    assert spy.reads == ["__bool__"] * (linesearch.host_reads.n - reads0)
    assert spy.copies == []


def test_preprocess_takes_device_constants_as_they_are(monkeypatch):
    """``StyleTransfer`` keeps the constants as tensors on its device, and
    ``preprocess`` with tensors makes none from host data; the arithmetic is
    that of the host constants, bit for bit."""
    st = StyleTransfer(device="cpu")
    assert isinstance(st._mean, torch.Tensor) and st._mean.dtype == torch.float32
    np.testing.assert_array_equal(st._mean.numpy(), st.mean)
    np.testing.assert_array_equal(st._std.numpy(), st.std)
    x = torch.from_numpy(np.random.RandomState(3).rand(1, 6, 5, 3).astype(np.float32))
    ref = imgio.preprocess(x, st.mean, st.std)
    back = imgio.deprocess(ref, st.mean, st.std)
    made = []
    monkeypatch.setattr(torch, "as_tensor", lambda *a, **k: made.append(1))
    out = imgio.preprocess(x, st._mean, st._std)
    again = imgio.deprocess(out, st._mean, st._std)
    monkeypatch.undo()
    assert made == []
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(again.numpy(), back.numpy())
    with pytest.raises(ValueError, match="mean must be a torch.float64 tensor"):
        imgio.preprocess(x.double(), st._mean, st._std)


def test_pinned_buffers_and_events_exist_only_on_the_card(packages, images, monkeypatch):
    """On the CPU a record's event is the host stand-in, its loss buffer the
    stacked tensor, and nothing asks for pinned memory (which needs CUDA)."""
    _, pst = packages
    content, style, init = images
    pinned, records, real_empty = [], [], torch.empty
    real = pst._dispatch_chunk

    def empty(*a, **k):
        if k.get("pin_memory"):
            pinned.append(a)
        return real_empty(*a, **k)

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(pst, "_dispatch_chunk", lambda *a, **k: records.append(real(*a, **k))
                        or records[-1])
    pst.stylize(content, style, _cfg(), callback=lambda ev: ev.get_state(), init_image=init)
    assert pinned == [] and pst._copy_stream is None and len(records) == 6
    for rec in records:
        assert isinstance(rec.event, api._HostEvent)
        assert rec.loss_host.device.type == "cpu" and rec.loss_host.shape == (4, 3)
        assert rec.keys == TERMS and rec.snap.shape == (*rec.image.shape[1:3], 3)


def test_pipeline_auto_rule():
    """None pipelines below REMAT_AUTO_PIXELS and not at it; True and False
    force it (JAX ``_pipeline_auto``)."""
    px = api.REMAT_AUTO_PIXELS
    assert StylizeConfig().pipeline_chunks is None
    assert api._pipeline_auto(StylizeConfig(), px - 1)
    assert not api._pipeline_auto(StylizeConfig(), px)
    assert api._pipeline_auto(StylizeConfig(pipeline_chunks=True), px)
    assert not api._pipeline_auto(StylizeConfig(pipeline_chunks=False), 1)
    assert api._PIPELINE_DEPTH == 2


def test_callback_errors_reach_the_caller_and_the_worker_stops(packages, images):
    """A callback that raises on a pipelined scale stops the run with its
    error, as on a sequential one, and no worker thread outlives the call."""
    _, pst = packages
    content, style, init = images

    def boom(ev):
        if ev.iteration == 6:
            raise KeyError("from the callback")

    for pipelined in (False, True):
        with pytest.raises(KeyError, match="from the callback"):
            pst.stylize(content, style, _cfg(pipeline_chunks=pipelined), callback=boom,
                        init_image=init)
    assert not [t for t in threading.enumerate() if t.name.startswith("stylize-callback")]


@pytest.mark.parametrize("flags", [[], ["--no-pipeline"]])
def test_cli_pipeline_flag_matches_the_jax_cli(tmp_path, monkeypatch, flags):
    """``--no-pipeline`` is ``pipeline_chunks=False`` and no flag ``None``;
    every other field of the config equals the JAX CLI's."""
    from style_transfer_tpu import api as japi

    r = np.random.RandomState(0)
    content, style = str(tmp_path / "c.png"), str(tmp_path / "s.png")
    imgio.save_image(r.rand(40, 32, 3).astype(np.float32), content)
    imgio.save_image(r.rand(32, 40, 3).astype(np.float32), style)
    common = [content, style, "--size", "32", "--min-scale", "32", "-i", "2",
              "--random-weights", "-o", str(tmp_path / "o.png")] + flags
    configs = {}
    for name, mod, st_cls, extra in (("jax", jcli, japi.StyleTransfer, ["--devices", "0"]),
                                     ("port", cli, api.StyleTransfer, ["--device", "cpu"])):
        seen = []

        def stylize(self, content, styles, config=None, _seen=seen, **kw):
            _seen.append(config)
            return np.zeros((32, 26, 3), np.uint8)

        monkeypatch.setattr(st_cls, "stylize", stylize)
        assert mod.main(common + extra) == 0
        configs[name] = seen[0]
    jcfg, pcfg = configs["jax"], configs["port"]
    assert pcfg.pipeline_chunks == jcfg.pipeline_chunks == (False if flags else None)
    for f in api.StylizeConfig.__dataclass_fields__:
        pv, jv = getattr(pcfg, f), getattr(jcfg, f)
        if f == "optimizer":
            pv, jv = vars(pv), vars(jv)
        assert pv == jv, f
