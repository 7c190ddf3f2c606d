"""The device plane's CUDA half on the card: device frames sealed from
CUDA tensors land back on the card byte for byte, the D2H pump and the
landing zone move their counters, a kept zone lands frames from its
device copy, and an aborted CUDA landing leaves nothing behind.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor ray_tpu, so it runs where only the port's dependencies
are installed; there, skip the jax-importing tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_device_plane.py
"""
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.cluster import device_plane as dp
from ray_tpu_torch.cluster import serialization as wire
from ray_tpu_torch.native.shm_store import NativeObjectStore

pytestmark = pytest.mark.cuda
OID = "c" * 28


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def arena(cuda):
    store = NativeObjectStore(
        path=os.path.join(
            tempfile.gettempdir(), f"t_cdev_{os.getpid()}_{time.time_ns()}.shm"
        ),
        capacity=3 << 28,
    )
    yield store
    store.close(unlink=True)


def _block(nbytes, dtype, device):
    n = nbytes // torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=device).manual_seed(nbytes)
    if dtype.is_floating_point:
        return torch.randn(n, generator=g, device=device).to(dtype)
    return torch.randint(-128, 127, (n,), generator=g, device=device).to(dtype)


def _bytes(t):
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "i8"])
@pytest.mark.parametrize("nbytes", [1 << 10, 32 << 20, 256 << 20],
                         ids=["1KiB", "32MiB", "256MiB"])
def test_cuda_frame_seal_and_land(arena, cuda, dtype, nbytes):
    """A CUDA tensor seals as a device frame (through the pump at or
    above its threshold), goes through the arena, and lands on the card
    with every byte equal."""
    src = _block(nbytes, dtype, cuda)
    before = dp.device_stats()
    parts, _ = wire.dumps_parts(src)
    mid = dp.device_stats()
    assert mid["device_frame_seals_total"] == before["device_frame_seals_total"] + 1
    pumped = mid["device_pump_chunks_total"] - before["device_pump_chunks_total"]
    assert (pumped > 0) == (nbytes >= 8 << 20)
    arena.put_frames(OID, parts)
    try:
        view = arena.get_view(OID)
        landed = wire.loads(view)
        del view
    finally:
        arena.delete(OID)
    after = dp.device_stats()
    assert after["device_frame_lands_device_total"] == mid["device_frame_lands_device_total"] + 1
    assert landed.device.type == "cuda" and landed.dtype == dtype
    assert landed.shape == src.shape
    assert torch.equal(_bytes(landed), _bytes(src))
    # host landing: the read-only host view, the same bytes
    parts, _ = wire.dumps_parts(src)
    with dp.landing("host"):
        host = wire.loads(memoryview(wire.join_parts(parts)))
    assert not isinstance(host, torch.Tensor) or host.device.type == "cpu"
    host_bytes = (
        _bytes(host) if isinstance(host, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(host).reshape(-1).view(np.uint8).copy())
    )
    assert torch.equal(host_bytes, _bytes(src))


def test_cuda_landing_zone_finish_and_abort(arena, cuda):
    """The zone copies the completed prefix to the card while stripes
    arrive: finish() gives chunks on the card that reassemble to the
    source; an abort drops them and abort_put leaves no zombie."""
    payload = np.random.default_rng(9).integers(0, 255, 5 << 20, dtype=np.uint8)
    dest = memoryview(bytearray(payload.tobytes()))
    zone = dp.DeviceLandingZone(dest, chunk_bytes=1 << 20)
    for off, n in [(2 << 20, 1 << 20), (0, 1500000),
                   (1500000, (2 << 20) - 1500000), (3 << 20, 2 << 20)]:
        zone.note_stripe(off, n)
    chunks = zone.finish()
    assert all(c.device.type == "cuda" for c in chunks)
    back = dp.assemble_device_tensor(chunks, "uint8", [5 << 20])
    assert torch.equal(back.cpu(), torch.from_numpy(payload))

    staged = arena.begin_put(OID, 6 << 20)
    zone = dp.DeviceLandingZone(staged, chunk_bytes=1 << 20)
    zone.note_stripe(0, 1 << 20)
    zone.note_stripe(1 << 20, 1 << 20)
    zone.note_stripe(3 << 20, 1 << 20)
    assert zone.snapshot()["chunks"] >= 2
    zone.abort()
    del staged
    arena.abort_put(OID)
    assert not arena.contains(OID)
    assert arena.zombie_count() == 0
    assert zone.snapshot()["chunks"] == 0


def test_cuda_kept_zone_lands_from_its_device_copy(cuda):
    """A frame sealed from a CUDA tensor, its bytes copied to the card by a
    landing zone, lands under ``landing("device")`` from the zone's device
    copy: wiping the host payload after ``finish()`` changes nothing."""
    src = _block(32 << 20, torch.float32, cuda)
    parts, total = wire.dumps_parts(src)
    dest = bytearray(wire.join_parts(parts))
    zone = dp.DeviceLandingZone(memoryview(dest), chunk_bytes=4 << 20)
    zone.note_stripe(16 << 20, total - (16 << 20))
    zone.note_stripe(0, 16 << 20)
    zone.finish()
    assert zone.device_buffer.device.type == "cuda"
    with dp.landing("device"):
        dp.keep_landed(dest, zone.device_buffer)
        dest[len(parts[0]):] = bytes(total - len(parts[0]))
        landed = wire.loads(memoryview(dest))
    assert landed.device.type == "cuda" and landed.dtype == torch.float32
    assert torch.equal(_bytes(landed), _bytes(src))


def test_cuda_socket_get_lands_through_a_pinned_zone(arena, monkeypatch):
    """On a card, ``fetch_bytes(land="device")`` under ``landing("device")``
    lands the stripes in pinned memory, copies them to the card as they
    arrive, and the tensor lands from that copy: wiping the fetched host
    bytes before the deserialize changes nothing."""
    from ray_tpu_torch.cluster import transport as tp

    monkeypatch.setenv("RAY_TPU_NET_STRIPE_BYTES", str(4 << 20))
    src = _block(64 << 20, torch.bfloat16, torch.device("cuda"))
    parts, total = wire.dumps_parts(src)
    arena.put_frames(OID, parts)
    srv = tp.DataPlaneServer(arena, "nodesrv", "tok", lambda: 1)
    link = tp.PeerLink("lk0", "nodesrv", srv.endpoint, "tok", 1, "nodecli")
    try:
        before = dp.device_stats()["device_land_chunks_total"]
        with dp.landing("device"):
            got = tp.fetch_bytes(link, OID, land="device")
            assert isinstance(got, np.ndarray) and len(got) == total
            assert dp.device_stats()["device_land_chunks_total"] >= before + 16
            got[len(parts[0]):] = 0
            landed = wire.loads(memoryview(got))
        assert landed.device.type == "cuda" and landed.dtype == torch.bfloat16
        assert torch.equal(_bytes(landed), _bytes(src))
    finally:
        link.close()
        srv.close()
        arena.delete(OID)


def test_cuda_rdt_codec_lands_on_the_card(cuda):
    from ray_tpu_torch import rdt

    src = _block(1 << 20, torch.bfloat16, cuda).reshape(512, -1)
    ok, out = rdt.decode_tensor(rdt.encode_tensor(src))
    assert ok and out.device.type == "cuda" and out.dtype == torch.bfloat16
    assert torch.equal(_bytes(out), _bytes(src))
