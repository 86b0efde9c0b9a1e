"""The port's host I/O against the JAX package's, on the CPU: PNG read and
write, the event ring and packetizer, the event-file reader, the frame
loader, the sequence scheduler, and ``SyntheticSequence.write_dataset``.

The port builds its own copy of the host runtime (``csrc/host``) into
``slam_eds_tpu_torch/_build``; the JAX package loads ``native/``'s. Every
I/O comparison here is bitwise (arrays with ``assert_array_equal``, counts
and medians with ``==``): the two libraries are the same C++ code, and the
pure-Python ring, reader and PNG unfilter must give what they give. The
ring's counters are held to JAX's native ring (the JAX package's numpy ring
counts backward steps differently; ROADMAP §3). ``write_dataset``'s
tolerances are in its test.
"""
import struct
import zlib

import numpy as np
import pytest

from slam_eds_tpu.io import event_buffer as jeb
from slam_eds_tpu.io import frame_loader as jfl
from slam_eds_tpu.io import image_rw as jrw

from slam_eds_tpu_torch.io import event_buffer as teb
from slam_eds_tpu_torch.io import frame_loader as tfl
from slam_eds_tpu_torch.io import image_rw as trw


@pytest.fixture(scope="module")
def native():
    """Both host libraries, built (the port's at first use here)."""
    if not teb.available():
        pytest.skip(f"the port's host runtime did not build: "
                    f"{teb.build_error()}")
    if not jeb.available():
        pytest.skip("the JAX package's native runtime did not build")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _images(rng):
    return {"gray8": rng.integers(0, 256, (37, 53), dtype=np.uint8),
            "gray16": rng.integers(0, 65536, (21, 17), dtype=np.uint16),
            "rgb8": rng.integers(0, 256, (19, 23, 3), dtype=np.uint8)}


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_png_round_trip_and_cross_read(tmp_path, rng, kind):
    """Round trip bitwise; the two writers write the same bytes, and each
    package reads the other's file bitwise."""
    img = _images(rng)[kind]
    pt, pj = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    trw.write_png(pt, img)
    jrw.write_png(pj, img)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for read in (trw.read_png, jrw.read_png):
        for path in (pt, pj):
            out = read(path)
            assert out.dtype == img.dtype
            np.testing.assert_array_equal(out, img)


def _png_with_filters(img: np.ndarray) -> bytes:
    """An 8-bit gray or RGB PNG whose row r uses filter r % 5 (None, Sub,
    Up, Average, Paeth), encoded here so that every unfilter path runs."""
    a = img.astype(np.int64).reshape(img.shape[0], -1)
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = []
    prev = np.zeros(a.shape[1], np.int64)
    for r, cur in enumerate(a):
        f = r % 5
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8)
                    .tobytes())
        prev = cur
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray8", "rgb8"])
def test_png_all_filters_native_python_and_jax(tmp_path, rng, native, kind,
                                               monkeypatch):
    """Rows with filters 0-4 decode to the source bitwise through the
    port's host unfilter, its Python unfilter, its native decoder and the
    JAX reader."""
    img = _images(rng)[kind]
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(_png_with_filters(img))
    np.testing.assert_array_equal(trw.read_png(p), img)
    np.testing.assert_array_equal(tfl.read_png_native(p), img)
    np.testing.assert_array_equal(jrw.read_png(p), img)
    monkeypatch.setattr(trw, "_native", lambda: None)
    np.testing.assert_array_equal(trw.read_png(p), img)


def test_frame_loader_matches_jax_and_recovers(tmp_path, rng, native):
    """The prefetching loader gives the frames in order, bitwise JAX's
    loader's; a file that fails to decode raises and the loader goes on."""
    paths = []
    for k in range(7):
        p = str(tmp_path / f"f{k}.png")
        if k == 3:
            with open(p, "wb") as f:
                f.write(b"not a png")
        else:
            trw.write_png(p, rng.integers(0, 256, (24, 32), dtype=np.uint8))
        paths.append(p)
    outs = []
    for mod in (tfl, jfl):
        loader = mod.FrameLoader(paths, n_threads=3, depth=2)
        got = []
        for k in range(len(paths)):
            if k == 3:
                with pytest.raises(ValueError):
                    loader.next()
                continue
            got.append(loader.next())
        assert loader.next() is None
        outs.append(got)
        if hasattr(loader, "close"):
            loader.close()
    for a, b, path in zip(*outs, [p for k, p in enumerate(paths) if k != 3]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, trw.read_png(path))


# ---------------------------------------------------------------------------
# Event ring, reader, scheduler
# ---------------------------------------------------------------------------

def _batches(rng):
    """Event batches with a few backwards timestamps."""
    t = 0.0
    out = []
    for n in (200, 900, 50, 700, 300):
        ts = t + np.cumsum(rng.uniform(0, 1e-3, n))
        ts[rng.choice(n, 3, replace=False)] -= 5e-3       # non-monotonic
        t = float(ts.max())
        out.append((rng.uniform(0, 128, n).astype(np.float32),
                    rng.uniform(0, 96, n).astype(np.float32), ts,
                    rng.choice([-1.0, 1.0], n).astype(np.float32)))
    return out


def _script(ring, batches):
    """push / pop_packet / pop_until with overflow; every result."""
    res = []

    def pop(kind, *args):
        xs, ys, ts, ps, n, med = getattr(ring, kind)(*args)
        # arrays are only defined where something was popped
        res.append((kind, n, med) + ((xs, ys, ts, ps) if n else ()))

    res.append(("push", ring.push(*batches[0])))
    pop("pop_packet", 50, 64)
    res.append(("push", ring.push(*batches[1])))           # overflows
    res.append(("state", len(ring), ring.free_space, ring.dropped,
                ring.nonmonotonic))
    pop("pop_until", float(batches[1][2][100]), 128)
    pop("pop_packet", 1000, 256)
    res.append(("push", ring.push(*batches[2])))
    pop("pop_until", 1e9, 2048)
    pop("pop_until", 1e9, 16)                               # empty
    for b in batches[3:]:
        res.append(("push", ring.push(*b)))
        pop("pop_packet", 333, 400)
    res.append(("state", len(ring), ring.free_space, ring.dropped,
                ring.nonmonotonic))
    return res


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[0] == y[0]
        for u, v in zip(x, y):
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v, (x[0], u, v)


@pytest.mark.parametrize("ring_kind", ["native", "python"])
def test_event_ring_matches_jax(rng, native, ring_kind):
    batches = _batches(rng)
    want = _script(jeb.EventRing(1000), batches)
    ring = (teb.EventRing if ring_kind == "native"
            else teb.PurePythonRing)(1000)
    _assert_same(_script(ring, batches), want)
    assert want[3][3] > 0 and want[3][4] > 0       # drops and repairs ran


def _events_file(path, rng, n=5000, t_end=1.0):
    ts = np.sort(rng.uniform(0, t_end, n))
    xs = rng.integers(0, 128, n)
    ys = rng.integers(0, 96, n)
    ps = rng.integers(0, 2, n)
    with open(path, "w") as f:
        f.write("# t x y p\n\n")
        for i in range(n):
            if i == 17:
                f.write("   # an indented comment\n")
            if i == 40:
                f.write("0.5 3 4\n")                 # truncated: dropped
            pol = -1 if (i % 97 == 0) else ps[i]
            f.write(f"{ts[i]:.9f} {xs[i]} {ys[i]} {pol}\n")
    return path


@pytest.mark.parametrize("reader_kind", ["native", "python"])
def test_event_file_reader_matches_jax(tmp_path, rng, native, reader_kind):
    """Chunked reads and pumping into a small ring give JAX's reader's
    arrays."""
    path = _events_file(str(tmp_path / "events.txt"), rng)
    cls = teb.EventFileReader if reader_kind == "native" \
        else teb.PurePythonReader
    tr, jr = cls(path), jeb.EventFileReader(path)
    total = 0
    while True:
        a, b = tr.read(777), jr.read(777)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
        total += len(a[0])
        if len(a[0]) == 0:
            break
    assert total == 5000
    tr, jr = cls(path), jeb.EventFileReader(path)
    t_ring, j_ring = teb.PurePythonRing(1500), jeb.EventRing(1500)
    while True:
        n_t, n_j = tr.pump(t_ring, 1000), jr.pump(j_ring, 1000)
        assert n_t == n_j
        a = t_ring.pop_packet(900, 1024)
        b = j_ring.pop_packet(900, 1024)
        assert a[4:] == b[4:]
        if a[4] == 0:
            break
        for u, v in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(u, v)
    assert j_ring.dropped == t_ring.dropped == 0


def _items(it):
    out = []
    for kind, payload in it:
        if kind == tfl.FRAME:
            out.append((kind, payload))
        else:
            xs, ys, ts, ps, n, med = payload
            out.append((kind, n, med, xs, ys, ts, ps))
    return out


def test_scheduler_matches_jax_and_python_schedule(tmp_path, rng, native):
    """The native scheduler's item sequence is JAX's scheduler's, and the
    runner's Python interleave (``python_schedule``) gives the same items
    over the native ring and reader and over the pure-Python ones."""
    path = _events_file(str(tmp_path / "events.txt"), rng, n=20000)
    times = np.sort(np.concatenate([[0.0, 1.0], rng.uniform(0, 1, 9)]))
    times[4] = times[3] + 1e-5          # an interval too thin for a packet
    cap = 1024

    def native_items(eb, fl):
        ring, reader = eb.EventRing(1 << 14), eb.EventFileReader(path)
        sched = fl.SequenceScheduler(ring, reader, times, cap, min_events=64)
        return _items(iter(sched.next, (fl.DONE, None)))

    want = native_items(jeb, jfl)
    assert sum(i[0] == jfl.EVENTS for i in want) > len(times)
    _assert_same(native_items(teb, tfl), want)
    for ring, reader in (
            (teb.EventRing(1 << 14), teb.EventFileReader(path)),
            (teb.PurePythonRing(1 << 14), teb.PurePythonReader(path))):
        _assert_same(_items(tfl.python_schedule(ring, reader, times, cap,
                                                min_events=64)), want)


# ---------------------------------------------------------------------------
# write_dataset
# ---------------------------------------------------------------------------

def test_write_dataset_matches_jax(tmp_path):
    """The port's ``write_dataset`` against JAX's at 128x96 over 6 frames,
    with a packet capacity above every interval's event count (no uniform
    subsampling, which would turn one event more into a shifted pick of all
    the others): images.txt and calib.yaml identical; groundtruth.txt within
    2e-8 per printed number (float32 poses printed to 9 decimals); the
    frames decode bitwise or within one gray level (a float32 render that
    rounds across .5); events.txt holds the same events but for at most
    1e-4 of them, and each event on one side only is a contrast-threshold
    crossing that the JAX render itself puts within 1e-3 of the threshold
    (|d log I| / C within 1e-3 of an integer)."""
    import jax.numpy as jnp
    from collections import Counter
    from slam_eds_tpu.io.dataset import SyntheticSequence as JSeq
    from slam_eds_tpu.utils.cameras import Pinhole as JPin
    from slam_eds_tpu_torch.io.dataset import SyntheticSequence as TSeq
    from slam_eds_tpu_torch.utils.cameras import Pinhole as TPin

    w, h, n = 128, 96, 6
    kw = dict(num_frames=n, events_per_packet=1 << 20, motion_scale=0.35)
    jseq = JSeq(JPin(jnp.float32(110.0), jnp.float32(110.0),
                     jnp.float32(63.5), jnp.float32(47.5), w, h), **kw)
    tseq = TSeq(TPin(110.0, 110.0, 63.5, 47.5, w, h), device="cpu", **kw)
    jd, td = tmp_path / "jax", tmp_path / "port"
    jseq.write_dataset(str(jd))
    tseq.write_dataset(str(td))
    for name in ("images.txt", "calib.yaml"):
        assert (td / name).read_text() == (jd / name).read_text()
    np.testing.assert_allclose(np.loadtxt(td / "groundtruth.txt"),
                               np.loadtxt(jd / "groundtruth.txt"),
                               rtol=0, atol=2e-8)
    for k in range(n):
        a = trw.read_png(str(td / f"images/frame_{k:06d}.png"))
        b = jrw.read_png(str(jd / f"images/frame_{k:06d}.png"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    tev = (td / "events.txt").read_text().splitlines()
    jev = (jd / "events.txt").read_text().splitlines()
    only = (Counter(tev) - Counter(jev)) + (Counter(jev) - Counter(tev))
    assert len(jev) > 50000 and sum(only.values()) <= 1e-4 * len(jev)
    times = jseq.times
    for line in only:
        t, x, y, _ = line.split()
        t, x, y = float(t), int(x), int(y)
        k = int(np.searchsorted(times, t)) - 1
        s = int(round((t - times[k]) / (times[k + 1] - times[k])
                      * jseq.micro_steps + 0.5))
        logs = []
        for step in (s - 1, s):
            a = step / jseq.micro_steps
            tau = (1 - a) * jseq.taus[k] + a * jseq.taus[k + 1]
            img = np.asarray(jseq._render(jnp.asarray(tau))[0])
            logs.append(np.log(img + 20.0))
        ratio = abs(logs[1][y, x] - logs[0][y, x]) / jseq.ct
        assert abs(ratio - round(ratio)) < 1e-3, (line, ratio)
