"""The port's shm ring channels and mutable-object channels, and their
parity with the JAX package's.

Mirrors the three ring cases of ``tests/test_hotpath.py`` (wrap-around,
full then close, SIGKILL mid-write with the orphan sweep) and the four
cases of ``tests/test_channels.py`` on ``ray_tpu_torch``, with the same
assertions. Parity (data movement is exact, so every byte must match):

- a ring written by the reference's ``ShmChannel`` is read by the port's,
  and the other way round; ints, bytes, a numpy array and a bf16 array
  come back equal;
- the RDT codec's bytes for numpy arrays are equal across the packages,
  and each package decodes the other's.
"""
import os
import signal
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.experimental import Channel, ChannelClosed


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's head brings its scheduler up on cuda and raises without it;
    # here its rounds run on the host (agents and workers inherit this)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


# ---------------------------------------------------------------------------
# ring hygiene: wrap-around, full, close, SIGKILL recovery, orphan sweep
# ---------------------------------------------------------------------------


def _ring_cls():
    from ray_tpu_torch.dag.channel import ShmChannel

    return ShmChannel


def test_ring_wrap_around_and_used(tmp_path):
    ShmChannel = _ring_cls()
    path = str(tmp_path / "wrap.ring")
    ch = ShmChannel(path, capacity=4096, create=True)
    try:
        msg = b"z" * 1200  # 3 msgs < capacity, forces wrap on refills
        for round_ in range(20):
            ch.put_bytes(msg)
            ch.put_bytes(msg)
            assert ch.used() == 2 * (len(msg) + 4)
            assert ch.get_bytes(timeout=1.0) == msg
            assert ch.get_bytes(timeout=1.0) == msg
            assert ch.used() == 0
    finally:
        ch.unlink()


def test_ring_full_then_close(tmp_path):
    from ray_tpu_torch.dag.channel import ChannelClosed as RingClosed
    from ray_tpu_torch.dag.channel import ChannelTimeout

    ShmChannel = _ring_cls()
    path = str(tmp_path / "full.ring")
    ch = ShmChannel(path, capacity=4096, create=True)
    try:
        with pytest.raises(ValueError):
            ch.put_bytes(b"y" * 5000)  # larger than the whole ring
        ch.put_bytes(b"x" * 3000)
        with pytest.raises(ChannelTimeout):
            ch.put_bytes(b"x" * 3000, timeout=0.2)  # full: times out
        ch.close_write()
        assert ch.get_bytes(timeout=1.0) == b"x" * 3000  # drains
        with pytest.raises(RingClosed):
            ch.get_bytes(timeout=1.0)  # closed + drained
    finally:
        ch.unlink()


def test_ring_dir_follows_tmpdir(tmp_path, monkeypatch):
    """Ring files live under the process's TMPDIR, as the shm arena's do:
    a process with another TMPDIR neither sees nor sweeps them."""
    import tempfile

    from ray_tpu_torch.dag.channel import channel_dir, ring_path, sweep_orphan_rings

    other = tmp_path / "other"
    mine = tmp_path / "mine"
    other.mkdir()
    mine.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", None)
    monkeypatch.setenv("TMPDIR", str(other))
    # a dead creator's ring under the other TMPDIR (pid 2**22 + 1 is past
    # the kernel's pid limit, so it is never alive)
    foreign = ring_path("foreign", pid=(1 << 22) + 1)
    open(foreign, "wb").close()
    assert foreign.startswith(str(other) + os.sep)

    monkeypatch.setattr(tempfile, "tempdir", None)
    monkeypatch.setenv("TMPDIR", str(mine))
    assert channel_dir() == os.path.join(str(mine), "ray_tpu_torch_dag")
    path = ring_path("probe")
    assert path == os.path.join(
        str(mine), "ray_tpu_torch_dag", f"probe.p{os.getpid()}.ring"
    )
    assert sweep_orphan_rings() == []
    assert os.path.exists(foreign)


def test_ring_sigkill_mid_write_recovery(tmp_path):
    """A producer SIGKILLed mid-stream must not wedge the reader (reads
    time out instead of crashing) and its pid-stamped ring file is
    reaped by the orphan sweep once the pid is dead."""
    from ray_tpu_torch.dag.channel import (
        ChannelTimeout,
        ring_path,
        sweep_orphan_rings,
    )

    ShmChannel = _ring_cls()
    code = (
        "import sys, time\n"
        "from ray_tpu_torch.dag.channel import ShmChannel, ring_path\n"
        "p = ring_path('hotpath_sigkill')\n"
        "ch = ShmChannel(p, capacity=1<<16, create=True)\n"
        "print(p, flush=True)\n"
        "i = 0\n"
        "while True:\n"
        "    ch.put_bytes(b'm' * 512, timeout=5.0)\n"
        "    i += 1\n"
    )
    # the producer's ring lies under a TMPDIR of its own, so no agent that
    # another test process starts sweeps it before this test does
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    directory = str(tmp / "ray_tpu_torch_dag")
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        stdout=subprocess.PIPE,
        text=True,
        env={**os.environ, "TMPDIR": str(tmp)},
    )
    try:
        path = proc.stdout.readline().strip()
        assert path.endswith(f".p{proc.pid}.ring")
        assert os.path.dirname(path) == directory
        deadline = time.monotonic() + 15
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.05)
        reader = ShmChannel(path)
        # drain a few messages, then kill the producer mid-stream
        assert reader.get_bytes(timeout=10.0) == b"m" * 512
        proc.kill()
        proc.wait()
        # the reader survives: drains what's there, then times out
        # cleanly (no crash, no wedge)
        try:
            while True:
                reader.get_bytes(timeout=0.3)
        except ChannelTimeout:
            pass
        reader.close()
        # dead-pid ring file is an orphan: the agent-start sweep reaps it
        removed = sweep_orphan_rings(directory=directory)
        assert path in removed
        assert not os.path.exists(path)
        # our own (live-pid) rings are never swept
        own = os.path.join(directory, os.path.basename(ring_path("hotpath_live_probe")))
        ShmChannel(own, capacity=4096, create=True).close()
        try:
            assert own not in sweep_orphan_rings(directory=directory)
            assert os.path.exists(own)
        finally:
            os.unlink(own)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# mutable-object channels (tests/test_channels.py)
# ---------------------------------------------------------------------------


def test_in_process_stream_and_close():
    ch = Channel(buffer_size_bytes=1 << 16)
    try:
        for i in range(100):
            ch.writer.write({"i": i})
        got = [ch.reader.read(timeout=5) for _ in range(100)]
        assert [g["i"] for g in got] == list(range(100))
        ch.writer.close_channel()
        with pytest.raises(ChannelClosed):
            ch.reader.read(timeout=5)
    finally:
        ch.destroy()


def test_read_timeout():
    ch = Channel(buffer_size_bytes=1 << 14)
    try:
        with pytest.raises(TimeoutError):
            ch.reader.read(timeout=0.2)
    finally:
        ch.destroy()


def test_tensor_payloads_use_raw_codec():
    ch = Channel(buffer_size_bytes=1 << 20)
    try:
        arr = np.arange(1024, dtype=np.float32).reshape(32, 32)
        ch.writer.write(arr)
        out = ch.reader.read(timeout=5)
        assert out.dtype == np.float32 and np.array_equal(out, arr)
        t = torch.arange(1024, dtype=torch.float32).reshape(32, 32).to(torch.bfloat16)
        ch.writer.write(t)
        out = ch.reader.read(timeout=5)
        assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
        assert torch.equal(out, t)
    finally:
        ch.destroy()


def test_cross_process_streaming():
    """Writer handle pickled into a cluster task; driver-side reader
    consumes the stream concurrently (same-host mutable object)."""
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.runtime import set_runtime

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    client = c.client()
    set_runtime(client)
    ch = Channel(buffer_size_bytes=1 << 18)
    try:

        def produce(writer, n):
            for i in range(n):
                writer.write(i * i)
            writer.close_channel()
            return n

        f = ray_tpu_torch.remote(produce).options(num_cpus=0.5, max_retries=0)
        ref = f.remote(ch.writer, 500)
        got = []
        # the reference reads until the close with no timeout; here each
        # read waits at most 5 s, and the whole stream 60 s: a worker
        # that is slow to start under load delays the first value only
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                got.append(ch.reader.read(timeout=5))
            except TimeoutError:
                continue
            except ChannelClosed:
                break
        assert got == [i * i for i in range(500)]
        assert ray_tpu_torch.get(ref, timeout=60) == 500
    finally:
        set_runtime(None)
        ch.destroy()
        client.shutdown()
        c.shutdown()


# ---------------------------------------------------------------------------
# parity with the JAX package: one ring, two packages
# ---------------------------------------------------------------------------


def _payloads(seed=5):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((17, 9)).astype(np.float32)
    bf16 = rng.standard_normal(301).astype(np.float32).astype(ml_dtypes.bfloat16)
    return [7, -123456789, rng.bytes(5000), f32, bf16]


def _as_bytes(v):
    if isinstance(v, torch.Tensor):
        return v.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(v).tobytes()


def _dtype_name(v):
    return str(v.dtype).rpartition(".")[2]


@pytest.mark.parametrize("writer_pkg", ["ray_tpu", "ray_tpu_torch"])
def test_ring_crosses_packages(tmp_path, writer_pkg):
    """The same ring file: one package writes, the other reads. Scalars
    and bytes come back equal; arrays come back with the same dtype name,
    shape and bytes (exact). The port writes its bf16 payload as a torch
    tensor, which the reference reads as a numpy bf16 array."""
    from ray_tpu.dag import channel as J
    from ray_tpu_torch.dag import channel as T

    W, R = (J, T) if writer_pkg == "ray_tpu" else (T, J)
    path = str(tmp_path / "x.ring")
    w = W.ShmChannel(path, capacity=1 << 20, create=True)
    r = R.ShmChannel(path, capacity=1 << 20)
    try:
        sent = _payloads()
        if W is T:
            sent[-1] = torch.from_numpy(
                sent[-1].view(np.uint16).astype(np.int16)
            ).view(torch.bfloat16)
        for v in sent:
            w.put(W.OK, v, timeout=5)
        w.put(W.STOP, None, timeout=5)
        for v in sent:
            tag, got = r.get(timeout=5)
            assert tag == R.OK
            if isinstance(v, (int, bytes)):
                assert got == v and type(got) is type(v)
            else:
                assert _dtype_name(got) == _dtype_name(v)
                assert tuple(got.shape) == tuple(v.shape)
                assert _as_bytes(got) == _as_bytes(v)
        assert r.get(timeout=5)[0] == R.STOP
    finally:
        w.unlink()
        r.close()


def _codec_arrays():
    rng = np.random.default_rng(21)
    return [
        rng.standard_normal((8, 5)).astype(np.float32),
        np.arange(-50, 50, dtype=np.int64),
        np.arange(30000, dtype=np.int32)[::3],  # non-contiguous
        rng.standard_normal(33).astype(">f8"),  # big-endian
        rng.random(40) < 0.5,
        rng.standard_normal((3, 4)).astype(np.float32).astype(ml_dtypes.bfloat16),
        (rng.standard_normal(6) + 1j * rng.standard_normal(6)).astype(np.complex64),
    ]


def test_rdt_codec_numpy_bytes_equal_across_packages():
    """The codec's bytes for numpy arrays are the reference's byte for
    byte, and each package decodes the other's frames to equal arrays."""
    from ray_tpu import rdt as J
    from ray_tpu_torch import rdt as T

    for arr in _codec_arrays():
        want = J.encode_tensor(arr)
        got = T.encode_tensor(arr)
        assert got is not None and got == want, arr.dtype
        for decode in (J.decode_tensor, T.decode_tensor):
            ok, out = decode(got)
            assert ok and out.dtype == np.asarray(arr).dtype.newbyteorder("=")
            assert np.array_equal(out, arr)
    # one known difference: the reference's encoder lifts a 0-d array to
    # shape [1] (np.ascontiguousarray), so it decodes 1-d; the port keeps
    # the shape, and only the header differs
    scalar = np.full((), 2.5, np.float16)
    ok, out = T.decode_tensor(T.encode_tensor(scalar))
    assert ok and out.shape == () and out == scalar
    ok, out = J.decode_tensor(J.encode_tensor(scalar))
    assert ok and out.shape == (1,) and out[0] == scalar
    assert T.encode_tensor(scalar)[-2:] == J.encode_tensor(scalar)[-2:]
    # and the rejects are the same (structured, object, masked, datetime)
    for bad in (
        np.zeros(3, dtype=[("a", "i4"), ("b", "f8")]),
        np.array([{"x": 1}, None], dtype=object),
        np.ma.masked_array([1, 2, 3], mask=[0, 1, 0]),
        np.array(["2026-01-01"], dtype="datetime64[D]"),
    ):
        assert J.encode_tensor(bad) is None and T.encode_tensor(bad) is None


def test_rdt_torch_frames_decode_in_the_reference():
    """A torch tensor's frame (kind ``torch``) decodes in the reference as
    a numpy array with the same dtype name and bytes."""
    from ray_tpu import rdt as J
    from ray_tpu_torch import rdt as T

    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.standard_normal((6, 7)).astype(np.float32))
    for t in (src, src.to(torch.bfloat16), src.T, (src * 10).to(torch.int8)):
        ok, out = J.decode_tensor(T.encode_tensor(t))
        assert ok and isinstance(out, np.ndarray)
        assert out.dtype.name == _dtype_name(t) and out.shape == tuple(t.shape)
        assert out.tobytes() == _as_bytes(t)
