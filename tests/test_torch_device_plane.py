"""The port's device-direct data plane on the CPU: seal, ship and land
torch tensors, and their parity with the JAX package's device frames.

Mirrors the fifteen cases of ``tests/test_device_plane.py`` on
``ray_tpu_torch``, with CPU torch tensors in place of CPU ``jax.Array``s
and the same assertions: the socket/chunked × device/host matrix,
mid-stripe severing, the landing zone's chunks, finish and abort, many
leaves and non-contiguous ones, the zero-copy seal, the pump on a bf16
tensor, the pump's no-monolithic-readout rule, the landing scope, the
kill switch, the arena pin, the RDT fast path, a state pytree through
the plane bit-equal to a host-bounce run (the elastic reshape's seal and
regather, through the port's ``train.elastic`` as the reference's case
goes through its own), and the debug block.

Parity (data movement is exact): the same seeded numpy data, sealed by
the reference as ``jax.Array`` leaves and by the port as tensors, fetched
through each package's native store and socket path in every
``native`` × ``land`` cell, lands byte for byte equal.
"""
import gc
import os
import tempfile
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.cluster import device_plane as dp
from ray_tpu_torch.cluster import serialization as wire
from ray_tpu_torch.cluster import transport as tp
from ray_tpu_torch.native.shm_store import NativeObjectStore

OID = "d" * 28


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtime brings its scheduler up on cuda and raises
    # without it; here the programs run on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


def _store(tag, capacity):
    return NativeObjectStore(
        path=os.path.join(
            tempfile.gettempdir(),
            f"t_tdev_{tag}_{os.getpid()}_{time.time_ns()}.shm",
        ),
        capacity=capacity,
    )


@pytest.fixture()
def arena():
    store = _store("src", 1 << 27)
    yield store
    store.close(unlink=True)


@pytest.fixture()
def served(arena):
    srv = tp.DataPlaneServer(arena, "nodesrv", "tok-secret", lambda: 100)
    link = tp.PeerLink(
        "lk0", "nodesrv", srv.endpoint, "tok-secret", 100, "nodecli"
    )
    yield arena, srv, link
    link.close()
    srv.close()


@pytest.fixture()
def rt():
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 8})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _device_pytree():
    """tensor leaves exercising the frame format corners: 2-D float32,
    bfloat16 (no buffer-protocol format char), a transposed
    non-contiguous view, a 0-d scalar, int8, plus non-tensor metadata."""
    base = torch.arange(64 * 48, dtype=torch.float32).reshape(64, 48)
    return {
        "w": base,
        "bf16": torch.arange(1000, dtype=torch.float32).to(torch.bfloat16),
        "t": base.T,  # non-contiguous export path
        "scalar": torch.tensor(3.25, dtype=torch.float32),
        "i8": (torch.arange(256, dtype=torch.int16) - 128).to(torch.int8),
        "meta": {"step": 7, "name": "x"},
    }


def _bytes(v):
    if isinstance(v, torch.Tensor):
        return v.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(v).tobytes()


def _name(v):
    return str(v.dtype).rpartition(".")[2]


def _assert_tree_equal(got, want, on_device):
    for key in ("w", "bf16", "t", "scalar", "i8"):
        g, w = got[key], want[key]
        if on_device:
            assert isinstance(g, torch.Tensor), f"{key}: {type(g)}"
        else:
            # host landing: read-only numpy views (bf16 too, here, where
            # ml_dtypes is loaded and numpy can name it)
            assert isinstance(g, np.ndarray), f"{key}: {type(g)}"
        assert _name(g) == _name(w), key
        assert tuple(g.shape) == tuple(w.shape), key
        assert _bytes(g) == _bytes(w), key
    assert got["meta"] == want["meta"]


# ---------------------------------------------------------------------------
# the 4-way matrix: socket / chunked-rpc framing x device / host landing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["socket", "chunked"])
@pytest.mark.parametrize("land", ["device", "host"])
def test_seal_land_roundtrip_matrix(served, monkeypatch, native, land):
    """The same tensor pytree round-trips byte-identically over the C
    socket path and the Python/chunked fallback, landing either as
    tensors (device) or read-only host views (host)."""
    if not native:
        monkeypatch.setenv("RAY_TPU_NATIVE_NET", "0")
    store, srv, link = served
    tree = _device_pytree()
    seals_before = dp.device_stats()["device_frame_seals_total"]
    parts, total = wire.dumps_parts(tree)
    assert dp.device_stats()["device_frame_seals_total"] > seals_before
    store.put_frames(OID, parts)
    got = tp.fetch_bytes(link, OID, land=land)
    assert len(got) == total
    with dp.landing(land):
        back = wire.loads(memoryview(got))
    _assert_tree_equal(back, tree, on_device=(land == "device"))


def test_mid_stripe_sever_resumes_device_frames(served, monkeypatch):
    """Severing the data sockets mid-striped-transfer of a device-frame
    object re-fetches only the lost stripes: the landed tensor is
    content-exact (no duplicated or dropped stripes)."""
    monkeypatch.setenv("RAY_TPU_NET_STRIPE_BYTES", str(1 << 20))
    monkeypatch.setenv("RAY_TPU_NET_STRIPE_CONNS", "2")
    store, srv, link = served
    arr = torch.from_numpy(
        np.random.default_rng(3).standard_normal(3 << 20).astype(np.float32)
    )
    parts, _ = wire.dumps_parts({"arr": arr})
    store.put_frames(OID, parts)
    got = {}

    def pull():
        got["data"] = tp.fetch_bytes(link, OID, land="device")

    t = threading.Thread(target=pull)
    t.start()
    for _ in range(3):
        time.sleep(0.02)
        srv.chaos_drop()
    t.join(timeout=60)
    assert not t.is_alive()
    assert srv.stats["chaos_drops"] >= 1
    back = wire.loads(memoryview(got["data"]))
    assert isinstance(back["arr"], torch.Tensor)
    assert torch.equal(back["arr"], arr)


def test_striped_fetch_to_store_lands_device(served, monkeypatch):
    """``fetch_to_store(land='device')`` with the landing zone forced on
    issues in-flight H2D chunks (counter grows) and still seals a
    byte-exact arena object that deserializes as a tensor."""
    monkeypatch.setenv("RAY_TPU_NET_STRIPE_BYTES", str(1 << 20))
    monkeypatch.setenv("RAY_TPU_DEVICE_LAND_ALWAYS", "1")
    store, srv, link = served
    arr = torch.arange((12 << 20) // 4, dtype=torch.float32)
    parts, total = wire.dumps_parts(arr)
    store.put_frames(OID, parts)
    dst = _store("dst", 1 << 26)
    try:
        chunks_before = dp.device_stats()["device_land_chunks_total"]
        size = tp.fetch_to_store(link, OID, dst, land="device")
        assert size == total
        assert dp.device_stats()["device_land_chunks_total"] > chunks_before
        back = wire.loads(dst.get_view(OID))
        assert isinstance(back, torch.Tensor)
        assert torch.equal(back, arr)
    finally:
        dst.close(unlink=True)


# ---------------------------------------------------------------------------
# abort: staged pages AND partial device buffers both freed (zombie sweep)
# ---------------------------------------------------------------------------


def test_aborted_device_landing_sweeps_clean(arena, monkeypatch):
    """An aborted device landing leaves nothing behind: the zone drops
    its partial device chunks, ``abort_put`` frees the staged pages, and
    the arena reports zero zombies."""
    monkeypatch.setenv("RAY_TPU_DEVICE_LAND_ALWAYS", "1")
    total = 6 << 20
    staged = arena.begin_put(OID, total)
    zone = dp.DeviceLandingZone(staged, chunk_bytes=1 << 20)
    # half the stripes land, then the transfer dies
    zone.note_stripe(0, 1 << 20)
    zone.note_stripe(1 << 20, 1 << 20)
    zone.note_stripe(3 << 20, 1 << 20)  # disjoint: not in the prefix
    snap = zone.snapshot()
    assert snap["chunks"] >= 2
    zone.abort()
    del staged
    arena.abort_put(OID)
    assert not arena.contains(OID)
    assert arena.zombie_count() == 0
    after = zone.snapshot()
    assert after["aborted"] and after["chunks"] == 0
    # the arena is fully reusable after the abort
    arena.put_bytes(OID, b"x" * 128)
    assert bytes(arena.get_view(OID)[:1]) == b"x"
    arena.delete(OID)


def test_landing_zone_finish_matches_source(monkeypatch):
    """Out-of-order disjoint stripes: ``finish()`` returns chunks that
    reassemble to exactly the source bytes."""
    monkeypatch.setenv("RAY_TPU_DEVICE_LAND_ALWAYS", "1")
    payload = np.random.default_rng(9).integers(
        0, 255, size=5 << 20, dtype=np.uint8
    ).tobytes()
    dest = memoryview(bytearray(payload))
    zone = dp.DeviceLandingZone(dest, chunk_bytes=1 << 20)
    # stripes arrive out of order, sizes not chunk-aligned
    spans = [(2 << 20, 1 << 20), (0, 1500000), (1500000, (2 << 20) - 1500000),
             (3 << 20, (5 << 20) - (3 << 20))]
    for off, n in spans:
        zone.note_stripe(off, n)
    chunks = zone.finish()
    flat = torch.cat([c.cpu() for c in chunks])
    assert flat.numpy().tobytes() == payload
    # and the raw single-tensor reassembly reads them as one tensor
    back = dp.assemble_device_tensor(chunks, "int32", [(5 << 20) // 4])
    assert back.dtype == torch.int32
    assert back.numpy().tobytes() == payload


def test_zone_copies_outside_its_lock_and_abort_waits(monkeypatch):
    """A stripe's thread copying the prefix does not hold up the other
    stripes' threads (they only merge their spans), and ``abort()``
    returns only once no copy reads the staged pages."""
    monkeypatch.setenv("RAY_TPU_DEVICE_LAND_ALWAYS", "1")
    release, copying = threading.Event(), threading.Event()
    real = dp.cpu_bytes

    def slow_cpu_bytes(src):
        copying.set()
        assert release.wait(30)
        return real(src)

    dest = memoryview(bytearray(4 << 20))
    zone = dp.DeviceLandingZone(dest, chunk_bytes=1 << 20)
    monkeypatch.setattr(dp, "cpu_bytes", slow_cpu_bytes)
    first = threading.Thread(target=zone.note_stripe, args=(0, 1 << 20))
    first.start()
    assert copying.wait(30)
    t0 = time.monotonic()
    zone.note_stripe(2 << 20, 1 << 20)  # disjoint: merged, nothing to copy
    assert time.monotonic() - t0 < 5
    assert zone.snapshot()["shipped"] == 1 << 20
    aborted = threading.Event()
    stopper = threading.Thread(target=lambda: (zone.abort(), aborted.set()))
    stopper.start()
    assert not aborted.wait(0.3)  # the copy still reads the pages
    release.set()
    first.join(30)
    stopper.join(30)
    assert aborted.is_set() and zone.snapshot()["aborted"]


def test_kept_zone_lands_frames_from_its_copy(monkeypatch):
    """Under an explicit ``landing("device")`` scope a finished zone is
    kept, and the frames whose bytes lie in its host buffer land from the
    zone's copy: wiping the host payload after ``finish()`` changes
    nothing. Outside the scope nothing is kept and the land reads the
    host bytes."""
    monkeypatch.setenv("RAY_TPU_DEVICE_LAND_ALWAYS", "1")
    arr = torch.from_numpy(
        np.random.default_rng(5).standard_normal(3 << 18).astype(np.float32)
    )
    parts, total = wire.dumps_parts({"w": arr, "step": 3})
    dest = bytearray(wire.join_parts(parts))
    zone = dp.DeviceLandingZone(memoryview(dest), chunk_bytes=1 << 20)
    zone.note_stripe(1 << 20, total - (1 << 20))
    zone.note_stripe(0, 1 << 20)
    assert len(zone.finish()) >= 3
    payload = slice(total - arr.numel() * 4, total)
    with dp.landing("device"):
        dp.keep_landed(dest, zone.device_buffer)
        dest[payload] = bytes(arr.numel() * 4)  # wipe the host copy
        back = wire.loads(memoryview(dest))
    assert back["step"] == 3 and torch.equal(back["w"], arr)
    # the scope released the zone: the host bytes are read again
    zeros = wire.loads(memoryview(dest))["w"]
    assert not zeros.any()
    dp.keep_landed(dest, zone.device_buffer)  # no scope: not kept
    assert not wire.loads(memoryview(dest))["w"].any()


def test_socket_get_under_device_scope_lands_from_the_zone(served, monkeypatch):
    """``fetch_bytes(land="device")`` under ``landing("device")`` (the
    driver's ``rdt.get_tensor``) keeps its zone for the deserialize: the
    tensors land from the zone's copy, not from the fetched host bytes."""
    monkeypatch.setenv("RAY_TPU_DEVICE_LAND_ALWAYS", "1")
    monkeypatch.setenv("RAY_TPU_NET_STRIPE_BYTES", str(1 << 20))
    store, srv, link = served
    tree = _device_pytree()
    parts, total = wire.dumps_parts(tree)
    store.put_frames(OID, parts)
    with dp.landing("device"):
        before = dp.device_stats()["device_land_chunks_total"]
        got = tp.fetch_bytes(link, OID, land="device")
        assert dp.device_stats()["device_land_chunks_total"] > before
        head = len(parts[0])
        got[head:] = bytes(total - head)  # wipe every out-of-band buffer
        back = wire.loads(memoryview(got))
    _assert_tree_equal(back, tree, on_device=True)


# ---------------------------------------------------------------------------
# frame format corners
# ---------------------------------------------------------------------------


def test_many_leaf_and_noncontiguous_pytree_roundtrip():
    """An 80-leaf tensor pytree (>64 out-of-band buffers) with strided
    members round-trips content-exact through the wire format."""
    base = torch.arange(128 * 64, dtype=torch.float32).reshape(128, 64)
    tree = {f"leaf{i}": base[i : i + 2].T for i in range(78)}
    tree["flat"] = torch.arange(4096, dtype=torch.int32)
    tree["bf"] = torch.ones((33,), dtype=torch.bfloat16) * 1.5
    parts, _ = wire.dumps_parts(tree)
    back = wire.loads(memoryview(wire.join_parts(parts)))
    assert len(back) == 80
    for k, want in tree.items():
        assert isinstance(back[k], torch.Tensor), k
        assert back[k].dtype == want.dtype and torch.equal(back[k], want), k


def test_zero_copy_seal_on_cpu_backend():
    """A contiguous CPU tensor exports as a view of its own storage:
    sealing one must count as zero-copy."""
    arr = torch.arange(1 << 18, dtype=torch.float32)
    zc_before = dp.device_stats()["device_frame_zero_copy_total"]
    wire.dumps_parts(arr)
    assert dp.device_stats()["device_frame_zero_copy_total"] > zc_before
    host, zero_copy = dp.export_device_view(arr)
    assert zero_copy and host.data_ptr() == arr.data_ptr()


def test_pump_gather_bf16_no_buffer_protocol(monkeypatch):
    """``DeviceChunkPump.gather`` must not touch the buffer protocol:
    bfloat16/float8 have no buffer-protocol format char and are exactly
    the weight/KV dtypes that exceed the pump threshold on a card. Forced
    through the pump as if on a card, a bf16 seal stays content-exact —
    both the direct gather and the reducer's tiny-threshold pump path."""
    monkeypatch.setattr(dp, "_host_aliasing", lambda arr: False)
    arr = (torch.arange(2_000_000, dtype=torch.float32) % 251).to(torch.bfloat16)
    chunks_before = dp.device_stats()["device_pump_chunks_total"]
    out = dp.DeviceChunkPump(arr, chunk_bytes=1 << 20, depth=2).gather()
    assert dp.device_stats()["device_pump_chunks_total"] >= chunks_before + 4
    assert out.dtype == arr.dtype
    assert torch.equal(out, arr)
    # end to end: reducer with a tiny pump_threshold seals via the pump,
    # and the sealed frame lands back content-exact
    land_fn, (meta, buf) = dp.make_device_reducer(pump_threshold=1)(arr)
    back = land_fn(meta, buf.raw())
    assert torch.equal(back, arr)


def test_pumped_export_skips_monolithic_readout(monkeypatch):
    """On a card ``_pumped_export`` must go straight to the pump: probing
    with ``export_device_view`` would read the whole tensor off the card
    once (monolithic D2H) just to discard the host copy — double
    bandwidth on exactly the path the pump exists for."""
    monkeypatch.setattr(dp, "_host_aliasing", lambda arr: False)
    calls = []
    monkeypatch.setattr(dp, "export_device_view", lambda a: calls.append(a))
    arr = torch.arange(1 << 18, dtype=torch.float32)
    host, zero_copy = dp._pumped_export(arr)
    assert not calls and not zero_copy
    assert torch.equal(host, arr)
    # a CPU tensor IS host memory: plain zero-copy export
    monkeypatch.undo()
    host2, zc2 = dp._pumped_export(arr)
    assert zc2
    assert torch.equal(host2, arr)


def test_landing_requested_only_in_explicit_scope():
    """The landing-zone opt-in signal: True only inside an explicit
    ``landing("device")`` scope. The scope-less default (which also
    lands tensors at deserialize) must NOT opt generic socket gets into
    copying their raw byte stream to the card."""
    assert dp.landing_mode() == "device"  # scope-less default
    assert not dp.landing_requested()
    with dp.landing("device"):
        assert dp.landing_requested()
    with dp.landing("host"):
        assert not dp.landing_requested()
    assert not dp.landing_requested()


def test_kill_switch_disables_seal_but_keeps_frames_loadable(monkeypatch):
    """RAY_TPU_DEVICE_PLANE=0: no new device frames seal (torch's own
    reducer takes over), but frames sealed while the plane was ON still
    load — landing host-side, content-exact."""
    arr = torch.arange(1 << 16, dtype=torch.float32) * 2
    parts, _ = wire.dumps_parts(arr)  # sealed with the plane ON
    blob = wire.join_parts(parts)
    monkeypatch.setenv("RAY_TPU_DEVICE_PLANE", "0")
    seals_before = dp.device_stats()["device_frame_seals_total"]
    off_parts, _ = wire.dumps_parts(arr)
    assert dp.device_stats()["device_frame_seals_total"] == seals_before
    # plane-off seal still round-trips (torch's reducer path)
    off_back = wire.loads(memoryview(wire.join_parts(off_parts)))
    assert isinstance(off_back, torch.Tensor) and torch.equal(off_back, arr)
    # plane-ON frames remain loadable with the switch off: land host-side
    back = wire.loads(memoryview(blob))
    assert isinstance(back, np.ndarray)
    assert np.array_equal(back, arr.numpy())


def test_failed_export_fails_the_seal(monkeypatch):
    """With the plane on, a sealable tensor whose export fails is a failed
    seal: the error reaches the caller, and torch's own reducer (the host
    bounce) never takes over behind its back."""

    def broken(t):
        raise RuntimeError("export failed")

    monkeypatch.setattr(dp, "export_device_view", broken)
    seals = dp.device_stats()["device_frame_seals_total"]
    with pytest.raises(RuntimeError, match="export failed"):
        wire.dumps_parts({"w": torch.arange(1 << 12, dtype=torch.float32)})
    assert dp.device_stats()["device_frame_seals_total"] == seals
    # a subclass rides torch's own reducer, which rebuilds it around its
    # plain data tensor: that one seals as a frame
    monkeypatch.undo()
    param = torch.nn.Parameter(torch.ones(3))
    back = wire.loads(memoryview(wire.join_parts(wire.dumps_parts(param)[0])))
    assert isinstance(back, torch.nn.Parameter) and torch.equal(back, param)
    assert dp.device_stats()["device_frame_seals_total"] == seals + 1


# ---------------------------------------------------------------------------
# pin lifecycle: a landed value must not hold its arena page
# ---------------------------------------------------------------------------


def test_landed_value_releases_arena_pin_without_gc(arena):
    """Deleting a device-frame object right after a consumer landed it
    must not leave a zombie: the landed tensor is a copy, so the arena
    page is free as soon as the view is dropped, without a gc cycle."""
    arr = torch.arange((8 << 20) // 4, dtype=torch.float32)
    parts, _ = wire.dumps_parts(arr)
    arena.put_frames(OID, parts)
    gc.collect()
    gc.disable()
    try:
        view = arena.get_view(OID)
        landed = wire.loads(view)
        assert isinstance(landed, torch.Tensor)
        del view
        arena.delete(OID)
        # landed value still alive — its storage is a copy, so the arena
        # page must already be free (no deferred-gc pin)
        assert arena.zombie_count() == 0
        assert landed[5].item() == 5.0
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# consumers: RDT fast path + a state pytree bit-exact vs the host bounce
# ---------------------------------------------------------------------------


def test_rdt_put_get_device_fast_path(rt):
    """``rdt.put_tensor`` routes sealable tensors through the device
    plane: the consumer gets a tensor with identical content, and numpy
    arrays keep the raw-codec path."""
    from ray_tpu_torch import rdt

    arr = torch.arange(300_000, dtype=torch.float32) * 0.5
    ref = rdt.put_tensor(arr)
    out = rdt.get_tensor(ref)
    assert isinstance(out, torch.Tensor)
    assert torch.equal(out, arr)
    nref = rdt.put_tensor(np.arange(64, dtype=np.int64))
    nout = rdt.get_tensor(nref)
    assert type(nout) is np.ndarray and nout[-1] == 63


def test_state_through_the_plane_bitexact_vs_host_bounce(rt, monkeypatch):
    """Elastic reshape regather over the device plane produces bitwise
    the same state as a host-bounce (plane off) run, and the plane's
    leaves come back as tensors with ``requires_grad`` kept."""
    from ray_tpu_torch.train.elastic import (
        fetch_sealed,
        regather_state,
        seal_rank_state,
    )

    rng = np.random.default_rng(11)
    state = {
        "w": torch.from_numpy(rng.standard_normal((37, 8)).astype(np.float32)),
        "opt": {
            "m": torch.from_numpy(rng.standard_normal(513).astype(np.float32)),
            "count": 7,
        },
        "p": torch.from_numpy(rng.standard_normal(9).astype(np.float32)).requires_grad_(),
    }

    def run():
        hexes = [
            seal_rank_state(
                state, 5, rank, 2, 4, elastic_shard_rules=(r"^opt/m$",)
            )[0]
            for rank in range(2)
        ]
        # the local runtime keeps a put by reference: each sealed payload
        # then crosses the wire as a worker's seal would
        payloads = []
        for h in hexes:
            parts, _ = wire.dumps_parts(fetch_sealed(h))
            payloads.append(wire.loads(memoryview(wire.join_parts(parts))))
        rebuilt, step = regather_state(payloads)
        assert step == 5
        return rebuilt

    seals = dp.device_stats()["device_frame_seals_total"]
    dev = run()
    # each rank's payload goes through the plane's pickler: the two full
    # tensor leaves and its two virtual slices of opt/m, as device frames
    assert dp.device_stats()["device_frame_seals_total"] == seals + 8
    assert isinstance(dev["opt"]["m"], torch.Tensor)
    monkeypatch.setenv("RAY_TPU_DEVICE_PLANE", "0")
    host = run()
    for get in (lambda s: s["w"], lambda s: s["opt"]["m"], lambda s: s["p"]):
        a, b = get(dev), get(host)
        assert a.dtype == b.dtype and a.requires_grad == b.requires_grad
        assert _bytes(a.detach()) == _bytes(b.detach())  # bit-exact
        assert _bytes(a.detach()) == _bytes(get(state).detach())
    assert dev["opt"]["count"] == host["opt"]["count"] == 7


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def test_debug_block_and_metrics_publish():
    before = dp.device_stats()
    assert set(before) >= {
        "device_frame_seals_total",
        "device_frame_lands_total",
        "device_frame_bytes_total",
    }
    block = dp.debug_block()
    assert block["enabled"] is True
    published = dp.publish_device_metrics()
    assert published["device_frame_seals_total"] >= 0


# ---------------------------------------------------------------------------
# parity with the JAX package's device frames
# ---------------------------------------------------------------------------


def _seeded_leaves(seed=17):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((64, 33)).astype(np.float32),
        "bf16": rng.standard_normal(777).astype(np.float32).astype(ml_dtypes.bfloat16),
        "i8": rng.integers(-128, 127, 300, dtype=np.int8),
        "big": rng.standard_normal(3 << 18).astype(np.float32),
    }


def _fetch_landed(pkg, tree, native, land, monkeypatch):
    import importlib

    wire_m = importlib.import_module(f"{pkg}.cluster.serialization")
    tp_m = importlib.import_module(f"{pkg}.cluster.transport")
    dp_m = importlib.import_module(f"{pkg}.cluster.device_plane")
    store_m = importlib.import_module(f"{pkg}.native.shm_store")
    with monkeypatch.context() as mp:
        if not native:
            mp.setenv("RAY_TPU_NATIVE_NET", "0")
        store = store_m.NativeObjectStore(
            path=os.path.join(
                tempfile.gettempdir(), f"t_par_{pkg}_{os.getpid()}_{time.time_ns()}.shm"
            ),
            capacity=1 << 26,
        )
        srv = tp_m.DataPlaneServer(store, "nodesrv", "tok", lambda: 100)
        link = tp_m.PeerLink("lk0", "nodesrv", srv.endpoint, "tok", 100, "cli")
        try:
            seals = dp_m.device_stats()["device_frame_seals_total"]
            parts, _ = wire_m.dumps_parts(tree)
            assert dp_m.device_stats()["device_frame_seals_total"] == seals + len(tree)
            store.put_frames(OID, parts)
            got = tp_m.fetch_bytes(link, OID, land=land)
            with dp_m.landing(land):
                return wire_m.loads(memoryview(got))
        finally:
            link.close()
            srv.close()
            store.close(unlink=True)


@pytest.mark.parametrize("native", [True, False], ids=["socket", "chunked"])
@pytest.mark.parametrize("land", ["device", "host"])
def test_landed_bytes_equal_to_the_reference(monkeypatch, native, land):
    """The same numpy data sealed by the reference as ``jax.Array``
    leaves and by the port as tensors, fetched through each package's
    store in the same (native, land) cell: the landed leaves have equal
    dtype names, shapes and bytes."""
    import jax
    import jax.numpy as jnp

    leaves = _seeded_leaves()
    ref_tree = {k: jnp.asarray(v) for k, v in leaves.items()}
    jax.block_until_ready(list(ref_tree.values()))
    port_tree = {}
    for k, v in leaves.items():
        if v.dtype == ml_dtypes.bfloat16:
            port_tree[k] = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        else:
            port_tree[k] = torch.from_numpy(v.copy())
    want = _fetch_landed("ray_tpu", ref_tree, native, land, monkeypatch)
    got = _fetch_landed("ray_tpu_torch", port_tree, native, land, monkeypatch)
    for k, src in leaves.items():
        w, g = want[k], got[k]
        if land == "device":
            assert isinstance(w, jax.Array) and isinstance(g, torch.Tensor), k
            w = np.asarray(w)
        assert _name(g) == np.asarray(w).dtype.name == src.dtype.name, k
        assert tuple(g.shape) == np.asarray(w).shape == src.shape, k
        assert _bytes(g) == _bytes(w) == src.tobytes(), k
