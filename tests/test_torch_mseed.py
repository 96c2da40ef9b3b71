"""The port's miniSEED codec and reader (`data/mseed.py`,
`readers.data_reader_mseed`) against the JAX package's.

Files go both ways: what one package writes the other reads, the writers'
bytes are equal, and the samples are bit for bit the same.  Hand-built
records (built byte by byte from the SEED 2.4 specification, as
tests/test_mseed_fixtures.py builds them) cover both byte orders, records
with and without blockette 1000, and the float64 encoding that neither
writer produces.  The port's windowed read decodes only the records in
its window; it must give the samples of a whole-file decode followed by
`slice`.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu.data import mseed as jms  # noqa: E402
from seismic_bpmf_tpu.data.readers import (  # noqa: E402
    data_reader_mseed as jax_reader,
)
from seismic_bpmf_tpu.data.stream import (  # noqa: E402
    Stream as JStream, Trace as JTrace,
)

from seismic_bpmf_tpu_torch.data import mseed as tms  # noqa: E402
from seismic_bpmf_tpu_torch.data import (  # noqa: E402
    Stream, Trace, data_reader_mseed,
)

T0 = 1343264400.0  # 2012-07-26T01:00:00
ENCODINGS = ["INT16", "INT32", "FLOAT32", "STEIM1", "STEIM2"]


def _walk(rng, n, scale=1000.0):
    """Integer random walk (realistic seismic count series)."""
    return np.cumsum(rng.normal(0, scale, n)).astype(np.int32)


def _series(rng, encoding, n=6000):
    x = _walk(rng, n, scale=50.0)
    if encoding == "INT16":
        return (x % 30000).astype(np.int32)
    # differences sized for every Steim packing width, exactly
    # representable in the containers' float32 samples (< 2^24)
    spikes = rng.integers(0, n, 40)
    x[spikes] += rng.integers(-2**22, 2**22, 40).astype(np.int32)
    return x


def _same_stream(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        assert ta.id == tb.id
        assert ta.stats.sampling_rate == tb.stats.sampling_rate
        assert ta.stats.starttime == tb.stats.starttime
        assert ta.data.dtype == tb.data.dtype == np.float32
        np.testing.assert_array_equal(ta.data, tb.data)


def _trace(cls, x, sr=100.0, starttime=T0 + 0.123, sta="ST1", cha="HHZ"):
    return cls(x.astype(np.float32), station=sta, network="XX", channel=cha,
               location="00", sampling_rate=sr, starttime=starttime)


@pytest.mark.parametrize("record_length", [512, 4096])
@pytest.mark.parametrize("encoding", ENCODINGS)
def test_each_encoding_both_ways(tmp_path, encoding, record_length):
    rng = np.random.default_rng(11)
    x = _series(rng, encoding)
    jpath, tpath = str(tmp_path / "j.mseed"), str(tmp_path / "t.mseed")
    jms.write_mseed(JStream([_trace(JTrace, x)]), jpath, encoding=encoding,
                    record_length=record_length)
    tms.write_mseed(Stream([_trace(Trace, x)]), tpath, encoding=encoding,
                    record_length=record_length)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    # the port reads what the JAX writer wrote, and the reverse
    _same_stream(tms.read_mseed(jpath), jms.read_mseed(jpath))
    _same_stream(jms.read_mseed(tpath), tms.read_mseed(tpath))
    np.testing.assert_array_equal(tms.read_mseed(jpath)[0].data,
                                  x.astype(np.float32))


# ---------------------------------------------------------------------------
# hand-built records (SEED 2.4 ch. 8), independent of both writers
# ---------------------------------------------------------------------------

def _u(v, nbytes, big):
    return int(v).to_bytes(nbytes, "big" if big else "little",
                           signed=v < 0)


def _header(seq=1, sta="TST1", n_samp=0, fract=0, n_blk=1, blk_ofs=48,
            big=True, sr_factor=25):
    h = f"{seq:06d}".encode() + b"D "
    h += f"{sta:<5s}".encode() + b"00" + b"BHZ" + b"XX"
    h += _u(2012, 2, big) + _u(208, 2, big) + bytes([10, 0, 0, 0])
    h += _u(fract, 2, big) + _u(n_samp, 2, big) + _u(sr_factor, 2, big)
    h += _u(1, 2, big) + bytes([0, 0, 0, n_blk]) + _u(0, 4, big)
    h += _u(64, 2, big) + _u(blk_ofs, 2, big)
    assert len(h) == 48
    return h


def _b1000(encoding, word_big, rec_len_pow, big=True):
    return (_u(1000, 2, big) + _u(0, 2, big)
            + bytes([encoding, 1 if word_big else 0, rec_len_pow, 0]))


def _pack_word(diffs, bits, dnib=None):
    w = 0 if dnib is None else dnib << 30
    for k, d in enumerate(diffs):
        w |= (d & ((1 << bits) - 1)) << (bits * (len(diffs) - 1 - k))
    return w & 0xFFFFFFFF


def _steim_payload(x0, xn, packed_words, n_frames):
    frames = [[0] * 16 for _ in range(n_frames)]
    frames[0][1], frames[0][2] = x0 & 0xFFFFFFFF, xn & 0xFFFFFFFF
    fi, wi = 0, 3
    for code, w in packed_words:
        frames[fi][wi] = w
        frames[fi][0] |= code << (2 * (15 - wi))
        wi += 1
        if wi == 16:
            fi, wi = fi + 1, 1
    return b"".join(_u(w, 4, True) for frame in frames for w in frame)


def _steim1_512():
    diffs = [1, -2, 3, 300, -500, 70000]
    x = np.concatenate([[1000], 1000 + np.cumsum(diffs)])
    words = [(1, _pack_word([0, 1, -2, 3], 8)),
             (2, _pack_word([300, -500], 16)),
             (3, _pack_word([70000], 32))]
    rec = (_header(n_samp=len(x)) + _b1000(10, True, 9) + b"\x00" * 8
           + _steim_payload(1000, int(x[-1]), words, 7))
    return rec, x


def _steim2_4096():
    groups = [
        (1, None, 8, [0, 5, -5, 10]),
        (2, 2, 15, [16000, -16000]),
        (2, 3, 10, [500, -500, 100]),
        (2, 1, 30, [300_000_000]),
        (3, 0, 6, [31, -31, 10, -10, 0]),
        (3, 1, 5, [15, -15, 7, -7, 1, -1]),
        (3, 2, 4, [7, -7, 3, -3, 1, -1, 2]),
    ]
    diffs = [d for _, _, _, ds in groups for d in ds][1:]
    x = np.concatenate([[100], 100 + np.cumsum(diffs)])
    words = [(code, _pack_word(ds, bits, dnib))
             for code, dnib, bits, ds in groups]
    rec = (_header(n_samp=len(x)) + _b1000(11, True, 12) + b"\x00" * 8
           + _steim_payload(100, int(x[-1]), words, 63))
    return rec, x


def _fixed_512(encoding, big):
    dt = {1: "i2", 5: "f8", 4: "f4", 3: "i4"}[encoding]
    x = np.array([1, -1, 32000, -32000, 12345], dt)
    if encoding == 5:
        x = np.array([1.25, -3.5e10, 1e-300, np.pi, -0.0])
    payload = x.astype((">" if big else "<") + dt).tobytes()
    rec = (_header(n_samp=len(x), big=big, sta="LE1" if not big else "BE1",
                   fract=5000)
           + _b1000(encoding, big, 9, big=big))
    rec += b"\x00" * (64 - len(rec)) + payload
    return rec + b"\x00" * (512 - len(rec)), x


def _legacy_pair():
    """A 512 B record without blockette 1000, then one with it."""
    words_a = [(1, _pack_word([0, 1, 1, 1], 8))]
    rec_a = _header(n_samp=4, n_blk=0, blk_ofs=0)
    rec_a += b"\x00" * (64 - len(rec_a)) + _steim_payload(10, 13, words_a, 7)
    words_b = [(1, _pack_word([0, 2, 2, 2], 8))]
    rec_b = (_header(seq=2, n_samp=4, fract=1600) + _b1000(11, True, 9)
             + b"\x00" * 8 + _steim_payload(14, 20, words_b, 7))
    return rec_a + rec_b, np.array([10, 11, 12, 13, 14, 16, 18, 20])


RECORDS = {
    "steim1_be_512": _steim1_512,
    "steim2_be_4096": _steim2_4096,
    "int16_le_512": lambda: _fixed_512(1, big=False),
    "int32_be_512": lambda: _fixed_512(3, big=True),
    "float32_le_512": lambda: _fixed_512(4, big=False),
    "float64_be_512": lambda: _fixed_512(5, big=True),
    "float64_le_512": lambda: _fixed_512(5, big=False),
    "no_blockette_1000": _legacy_pair,
}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_hand_built_records(tmp_path, name):
    buf, x = RECORDS[name]()
    path = tmp_path / f"{name}.mseed"
    path.write_bytes(buf)
    tr, jr = tms.read_mseed(str(path)), jms.read_mseed(str(path))
    _same_stream(tr, jr)
    np.testing.assert_array_equal(tr[0].data, x.astype(np.float32))
    t_rec, t_len = tms._parse_record(memoryview(buf))
    j_rec, j_len = jms._parse_record(memoryview(buf))
    assert t_len == j_len
    np.testing.assert_array_equal(t_rec["data"], j_rec["data"])
    assert t_rec["data"].dtype == j_rec["data"].dtype
    for key in ("station", "location", "channel", "network", "starttime",
                "sampling_rate"):
        assert t_rec[key] == j_rec[key], key


def test_record_without_blockette_1000_and_no_next_header_raises():
    rec = _header(n_samp=4, n_blk=0, blk_ofs=0)
    rec += b"\x00" * (700 - len(rec))
    with pytest.raises(ValueError, match="blockette 1000"):
        tms._parse_record(memoryview(rec))


# ---------------------------------------------------------------------------
# merging and windowed reads
# ---------------------------------------------------------------------------

def _segments(cls, case):
    """Segments of one channel: a gap, an agreeing and a conflicting
    overlap, and a segment written out of time order."""
    x = np.arange(400, dtype=np.float32)
    kw = dict(station="G", channel="HHZ", sampling_rate=25.0)
    if case == "gap":
        return [cls(x[:100], starttime=0.0, **kw),
                cls(x[200:300], starttime=8.0, **kw)]
    if case == "agree":
        return [cls(x[:100], starttime=0.0, **kw),
                cls(x[50:150], starttime=2.0, **kw)]
    if case == "conflict":
        return [cls(x[:100], starttime=0.0, **kw),
                cls(x[50:150] + 1000.0, starttime=2.0, **kw)]
    return [cls(x[300:400], starttime=12.0, **kw),   # out of order
            cls(x[:100], starttime=0.0, **kw),
            cls(x[90:200] + 1.0, starttime=3.6, **kw)]


CASES = ["gap", "agree", "conflict", "unordered"]


@pytest.mark.parametrize("case", CASES)
def test_merge_fill(case):
    _same_stream(tms.merge_fill(Stream(_segments(Trace, case))),
                 jms.merge_fill(JStream(_segments(JTrace, case))))


WINDOWS = [(None, None), (2.0, 5.0), (3.61, 7.99), (-5.0, 2.0),
           (11.0, None), (None, 0.5), (20.0, 30.0), (6.0, 5.0)]


@pytest.mark.parametrize("case", CASES)
def test_windowed_read_equals_whole_decode_then_slice(tmp_path, case):
    """Records of one file with gaps, overlaps and out-of-order starts:
    each window read equals the whole decode (merge) followed by
    `slice`, and the JAX package's read."""
    path = str(tmp_path / f"{case}.mseed")
    # INT32 records of 112 samples: several records a segment
    tms.write_mseed(Stream(_segments(Trace, case)), path, encoding="INT32")
    whole = tms.read_mseed(path)
    for start, end in WINDOWS:
        got = tms.read_mseed(path, start, end)
        _same_stream(got, whole.slice(start, end))
        _same_stream(got, jms.read_mseed(path, start, end))


@pytest.mark.parametrize("encoding", ["INT32", "STEIM2"])
def test_windowed_read_of_a_long_file(tmp_path, encoding):
    rng = np.random.default_rng(5)
    x = _series(rng, encoding, n=90_000)
    path = str(tmp_path / "long.mseed")
    tms.write_mseed(Stream([_trace(Trace, x, sr=100.0, starttime=T0)]), path,
                    encoding=encoding, record_length=4096)
    whole = tms.read_mseed(path)
    for start in (T0 + 0.004, T0 + 117.375, T0 + 899.0, T0 + 450.0):
        end = start + 4.0
        got = tms.read_mseed(path, start, end)
        _same_stream(got, whole.slice(start, end))
        _same_stream(got, jms.read_mseed(path, start, end))
        assert len(got[0].data) in (400, 401) or start > T0 + 890


# ---------------------------------------------------------------------------
# the tutorial folder reader
# ---------------------------------------------------------------------------

def _folder(tmp_path, rng):
    day = tmp_path / "2012" / "208"
    os.makedirs(day)
    t0 = float(np.datetime64("2012-07-26T00:00:00", "s").astype(np.int64))
    for sta in ("DC06", "DC07"):
        for comp in "NEZ":
            tr = Trace(_walk(rng, 25 * 1800).astype(np.float32),
                       station=sta, network="YH", channel=f"DP{comp}",
                       location="00", sampling_rate=25.0, starttime=t0)
            tms.write_mseed(
                Stream([tr]),
                str(day / f"YH.{sta}.00.DP{comp}_2012208.mseed"),
                encoding="STEIM2")
    return t0


READS = [
    dict(network="YH", stations=["DC06", "DC07"], channels="DP*",
         location="00", starttime="2012-07-26T00:10:00",
         endtime="2012-07-26T00:20:00"),
    dict(stations=["DC07"], channels="*Z",
         starttime=np.datetime64("2012-07-26T00:01:02.52"),
         endtime=np.datetime64("2012-07-26T00:01:06.52")),
    dict(stations="DC06", starttime="2012-07-26T00:29:50",
         endtime="2012-07-26T00:40:00"),
]


@pytest.mark.parametrize("i", range(len(READS)))
def test_data_reader_mseed_equals_the_jax_reader(tmp_path, i):
    _folder(tmp_path, np.random.default_rng(3))
    got = data_reader_mseed(str(tmp_path), **READS[i])
    assert len(got) > 0
    _same_stream(got, jax_reader(str(tmp_path), **READS[i]))


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_all_headers_at_once_equal_the_record_walk(tmp_path, encoding):
    """The vectorized header parse of a file of equal-length records
    gives the record-by-record walk's index, field for field."""
    rng = np.random.default_rng(9)
    st = Stream(_segments(Trace, "unordered"))
    st += _trace(Trace, _series(rng, encoding, n=3000), sta="ST2")
    path = str(tmp_path / "multi.mseed")
    tms.write_mseed(st, path, encoding=encoding)
    buf = open(path, "rb").read()
    fast = tms._uniform_index(buf, tms._parse_header(buf, 0))
    walk = tms._sequential_index(buf)
    assert fast is not None and fast.ids == walk.ids
    assert len(fast.ids) == 2
    for name in fast._fields[1:]:
        np.testing.assert_array_equal(getattr(fast, name),
                                      getattr(walk, name), err_msg=name)
