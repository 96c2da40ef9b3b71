"""Pure-NumPy miniSEED (SEED 2.4 data records) reader and writer.

Copy of `seismic_bpmf_tpu.data.mseed` (the subset of miniSEED the
tutorial's folder convention needs, BPMF/data_reader_examples.py:115-214):

  - fixed 48-byte header + blockette 1000 (+1001 skipped), big/little endian;
  - encodings: int16 (1), int32 (3), float32 (4), float64 (5),
    Steim1 (10), Steim2 (11);
  - a writer for INT16 / INT32 / FLOAT32 / STEIM1 / STEIM2 records.

Two changes, neither of which changes a sample:

  - `read_mseed(path, starttime, endtime)` walks the record headers first
    and decodes only the records that overlap the window.  The samples,
    start time and length are those of a whole-file decode, merge and
    `slice`, because the merge is computed from every record's header.
  - the Steim decode is vectorized over a record's words.
"""

from __future__ import annotations

import datetime
import struct
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from ..utils.time import epoch_from_utc, sec_to_samp
from .stream import Stream, Trace

_FIXED = 48
_EPOCH_ORDINAL = datetime.date(1970, 1, 1).toordinal()
_WIDTH = {1: 2, 3: 4, 4: 4, 5: 8}
_DTYPE = {1: "i2", 3: "i4", 4: "f4", 5: "f8"}


# ---------------------------------------------------------------------------
# Steim decoding
# ---------------------------------------------------------------------------

def _sign_extend(v: np.ndarray, bits) -> np.ndarray:
    bits = np.asarray(bits, np.int64)
    m = np.int64(1) << (bits - 1)
    return ((v.astype(np.int64) & ((np.int64(1) << bits) - 1)) ^ m) - m


# (values in the word, bits each) by (control code, decode nibble); a
# nibble of -1 stands for "any" (Steim1, and Steim2's code 1)
_STEIM1_LAYOUT = {(1, -1): (4, 8), (2, -1): (2, 16), (3, -1): (1, 32)}
_STEIM2_LAYOUT = {
    (1, -1): (4, 8),
    (2, 1): (1, 30), (2, 2): (2, 15), (2, 3): (3, 10),
    (3, 0): (5, 6), (3, 1): (6, 5), (3, 2): (7, 4),
}


def _layout_table(steim2: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(count, bits) tables indexed by 4 * code + nibble."""
    count = np.zeros(16, np.int64)
    bits = np.ones(16, np.int64)
    for (code, dnib), (c, b) in (_STEIM2_LAYOUT if steim2
                                 else _STEIM1_LAYOUT).items():
        for nib in (range(4) if dnib < 0 else (dnib,)):
            count[4 * code + nib], bits[4 * code + nib] = c, b
    return count, bits


_LAYOUT = {False: _layout_table(False), True: _layout_table(True)}


def _steim_diffs(words: np.ndarray, steim2: bool) -> np.ndarray:
    """Decode one record's Steim frames (u32 words, (n_frames, 16)) into
    the differences, in order (frame-0 words 1-2 are X0/Xn and skipped)."""
    frames = words.reshape(-1, 16).astype(np.int64)
    wi = np.arange(1, 16)
    codes = (frames[:, :1] >> (2 * (15 - wi))[None, :]) & 3
    data = frames[:, 1:]
    keep = np.ones(codes.shape, bool)
    keep[0, :2] = False  # X0 / Xn
    code, w = codes[keep], data[keep]
    count_t, bits_t = _LAYOUT[steim2]
    key = 4 * code + ((w >> 30) & 3)
    count, bits = count_t[key], bits_t[key]
    word = np.repeat(w, count)
    b = np.repeat(bits, count)
    # k-th value of a word of `count` values sits at bits * (count - 1 - k)
    first = np.cumsum(count) - count
    k = np.arange(len(word)) - np.repeat(first, count)
    shift = b * (np.repeat(count, count) - 1 - k)
    return _sign_extend(word >> shift, b)


def _decode_steim(payload: bytes, n_samp: int, big: bool,
                  steim2: bool) -> np.ndarray:
    n_frames = len(payload) // 64
    words = np.frombuffer(
        payload[: n_frames * 64], dtype=(">u4" if big else "<u4")
    )
    x0 = _sign_extend(
        np.array([np.int64(words.reshape(-1, 16)[0, 1])]), 32
    )[0]
    d = _steim_diffs(words, steim2)[:n_samp]
    # first difference links to the previous record; the first sample is X0
    x = np.empty(n_samp, np.int64)
    if n_samp:
        x[0] = x0
        if n_samp > 1:
            x[1:] = x0 + np.cumsum(d[1:n_samp])
    return x.astype(np.int32)


# ---------------------------------------------------------------------------
# Steim encoding (writer)
# ---------------------------------------------------------------------------

# (code, dnib, count, bits) packing choices, largest count first
_STEIM1_PACK = [(1, None, 4, 8), (2, None, 2, 16), (3, None, 1, 32)]
_STEIM2_PACK = [
    (3, 2, 7, 4), (3, 1, 6, 5), (3, 0, 5, 6), (1, None, 4, 8),
    (2, 3, 3, 10), (2, 2, 2, 15), (2, 1, 1, 30),
]


def _fits(v: np.ndarray, bits: int) -> bool:
    lim = np.int64(1) << (bits - 1)
    return bool(np.all(v >= -lim) and np.all(v < lim))


def _encode_steim(x: np.ndarray, n_frames: int, steim2: bool
                  ) -> Tuple[bytes, int]:
    """Greedy Steim1/2 packing of as many samples of `x` as fit in
    `n_frames` 64-byte frames.  Returns (payload bytes, n_encoded)."""
    x = x.astype(np.int64)
    d = np.diff(x, prepend=x[:1])  # d[0] unused on decode
    pack = _STEIM2_PACK if steim2 else _STEIM1_PACK
    frames = np.zeros((n_frames, 16), dtype=np.uint64)
    fi, wi = 0, 3  # frame 0 reserves words 1 (X0) and 2 (Xn)
    i = 0
    n = len(x)
    while i < n and fi < n_frames:
        for code, dnib, cnt, bits in pack:
            if i + cnt <= n and _fits(d[i : i + cnt], bits):
                w = np.uint64(0)
                if steim2 and dnib is not None:
                    w |= np.uint64(dnib) << np.uint64(30)
                mask = (np.int64(1) << bits) - 1
                vals = d[i : i + cnt] & mask
                for k, v in enumerate(vals):
                    w |= np.uint64(v) << np.uint64(bits * (cnt - 1 - k))
                frames[fi, wi] = w & np.uint64(0xFFFFFFFF)
                frames[fi, 0] |= np.uint64(code) << np.uint64(
                    2 * (15 - wi)
                )
                i += cnt
                break
        else:  # single sample too large even for the widest packing
            raise ValueError("sample difference exceeds Steim range")
        wi += 1
        if wi == 16:
            fi, wi = fi + 1, 1
    n_enc = i
    f0 = frames.reshape(-1, 16)
    f0[0, 1] = np.uint64(x[0] & 0xFFFFFFFF)
    f0[0, 2] = np.uint64(x[n_enc - 1] & 0xFFFFFFFF)
    return frames.astype(">u4").tobytes(), n_enc


# ---------------------------------------------------------------------------
# record parsing
# ---------------------------------------------------------------------------

class _Header(NamedTuple):
    """One record's header: what the decode needs and what the merge
    needs, without its samples."""

    network: str
    station: str
    location: str
    channel: str
    starttime: float
    sampling_rate: float
    n_samp: int
    n_data: int        # the samples the decode gives
    encoding: int
    word_big: bool
    data_ofs: int
    rec_len: int


def _parse_header(buf: bytes, pos: int) -> _Header:
    """Parse the header of the record at buf[pos:] (its blockettes too)."""
    (year_be,) = struct.unpack_from(">H", buf, pos + 20)
    bo = ">" if 1900 <= year_be <= 2100 else "<"
    (year, doy, hour, minute, sec, fract, n_samp, f, m, act, tcorr,
     data_ofs, blk_ofs) = struct.unpack_from(
        bo + "HHBBBxHHhhB3xiHH", buf, pos + 20)
    if f > 0:
        sr = f * m if m > 0 else -f / m
    elif f < 0:
        sr = -m / f if m > 0 else 1.0 / (f * m)
    else:
        sr = 0.0

    # walk blockettes for 1000 (encoding, word order, record length)
    enc, word_big, rec_len = 11, True, None
    ofs = blk_ofs
    while ofs:
        btype, nxt = struct.unpack_from(bo + "HH", buf, pos + ofs)
        if btype == 1000:
            enc = buf[pos + ofs + 4]
            word_big = buf[pos + ofs + 5] == 1
            rec_len = 1 << buf[pos + ofs + 6]
        if nxt <= ofs:
            break
        ofs = nxt
    if rec_len is None:
        # legacy record without blockette 1000: infer the record length by
        # scanning power-of-two offsets for the next valid fixed header
        # (6 ASCII digits + quality code) or the end of the buffer
        left = len(buf) - pos
        for cand in (128, 256, 512, 1024, 2048, 4096):
            if cand < _FIXED or cand > left:
                continue
            if cand == left:
                rec_len = cand
                break
            head = buf[pos + cand : pos + cand + 7]
            if head[:6].isdigit() and head[6:7] in b"DRQM":
                rec_len = cand
                break
        if rec_len is None:
            raise ValueError(
                "miniSEED record lacks blockette 1000 and no subsequent "
                "record header was found at a power-of-two offset; cannot "
                "infer the record length"
            )
    if enc in _WIDTH:
        payload_len = max(0, min(rec_len, len(buf) - pos) - data_ofs)
        if payload_len % _WIDTH[enc]:
            raise ValueError("buffer size must be a multiple of element size")
        n_data = min(n_samp, payload_len // _WIDTH[enc])
    elif enc in (10, 11):
        n_data = n_samp
    else:
        raise NotImplementedError(f"miniSEED encoding {enc} not supported")

    days = datetime.date(year, 1, 1).toordinal() - _EPOCH_ORDINAL + doy - 1
    ns = (((days * 24 + hour) * 60 + minute) * 60 + sec) * 1_000_000_000
    ns += fract * 100_000
    if not (act & 0x02) and tcorr:
        ns += tcorr * 100_000
    ids = buf[pos + 8 : pos + 20].decode("ascii", "replace")
    return _Header(
        network=ids[10:12].strip(), station=ids[0:5].strip(),
        location=ids[5:7].strip(), channel=ids[7:10].strip(),
        starttime=ns / 1e9, sampling_rate=float(sr), n_samp=n_samp,
        n_data=n_data, encoding=enc, word_big=word_big, data_ofs=data_ofs,
        rec_len=rec_len,
    )


def _decode(buf: bytes, pos: int, data_ofs: int, rec_len: int,
            encoding: int, word_big: bool, n_samp: int) -> np.ndarray:
    payload = buf[pos + data_ofs : pos + rec_len]
    if encoding in (10, 11):
        return _decode_steim(payload, n_samp, word_big,
                             steim2=(encoding == 11))
    dbo = ">" if word_big else "<"
    data = np.frombuffer(payload, dbo + _DTYPE[encoding])[:n_samp]
    return data.astype(np.int32) if encoding == 1 else data


def _parse_record(buf) -> Tuple[dict, int]:
    """Parse one record starting at buf[0]; returns (record dict incl.
    decoded samples, record length)."""
    buf = bytes(buf)
    h = _parse_header(buf, 0)
    rec = {
        "station": h.station, "location": h.location,
        "channel": h.channel, "network": h.network,
        "starttime": h.starttime, "sampling_rate": h.sampling_rate,
        "data": _decode(buf, 0, h.data_ofs, h.rec_len, h.encoding,
                        h.word_big, h.n_samp),
    }
    return rec, h.rec_len


class _Index(NamedTuple):
    """Every record with samples, in file order, as arrays (one entry a
    record), and the channel each belongs to."""

    ids: List[Tuple[str, str, str, str]]  # (net, sta, loc, cha) by channel
    channel: np.ndarray                   # each record's index into ids
    pos: np.ndarray
    starttime: np.ndarray
    sampling_rate: np.ndarray
    n_samp: np.ndarray
    n_data: np.ndarray
    encoding: np.ndarray
    word_big: np.ndarray
    data_ofs: np.ndarray
    rec_len: np.ndarray


def _index_of(pos, raw_ids, fields) -> _Index:
    """The index of the records with samples (`raw_ids`: each record's 12
    bytes of station, location, channel and network codes)."""
    keep = (fields["sampling_rate"] > 0) & (fields["n_data"] > 0)
    if not keep.any():
        return _Index([], np.zeros(0, np.int64), np.zeros(0, np.int64),
                      **{k: np.zeros(0) for k in fields})
    raw_ids = raw_ids[keep]
    uniq, first, inverse = np.unique(raw_ids, axis=0, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first)              # channels by first appearance
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    ids = []
    for row in uniq[order]:
        t = bytes(row).decode("ascii", "replace")
        ids.append((t[10:12].strip(), t[0:5].strip(), t[5:7].strip(),
                    t[7:10].strip()))
    return _Index(ids=ids, channel=rank[inverse.reshape(-1)],
                  pos=np.asarray(pos)[keep],
                  **{k: v[keep] for k, v in fields.items()})


def _sequential_index(buf: bytes) -> _Index:
    """Walk the records one header at a time."""
    heads, pos = [], 0
    while pos + _FIXED <= len(buf):
        h = _parse_header(buf, pos)
        heads.append((pos, h))
        pos += h.rec_len
    raw = np.frombuffer(b"".join(buf[p + 8: p + 20] for p, _ in heads),
                        np.uint8).reshape(-1, 12)
    fields = {f: np.array([getattr(h, f) for _, h in heads])
              for f in ("starttime", "sampling_rate", "n_samp", "n_data",
                        "encoding", "word_big", "data_ofs", "rec_len")}
    fields["starttime"] = fields["starttime"].astype(np.float64)
    fields["sampling_rate"] = fields["sampling_rate"].astype(np.float64)
    return _index_of([p for p, _ in heads], raw, fields)


def _uniform_index(buf: bytes, first: _Header):
    """All headers at once, when every record has the first one's length,
    byte order, and a blockette 1000 saying so; else None."""
    rec_len = first.rec_len
    if len(buf) % rec_len or len(buf) < 2 * rec_len:
        return None
    a = np.frombuffer(buf, np.uint8).reshape(-1, rec_len)
    n = len(a)
    year_be = (a[:, 20].astype(np.int64) << 8) | a[:, 21]
    big = (1900 <= year_be) & (year_be <= 2100)
    if not (big.all() or not big.any()):
        return None
    bo = ">" if big[0] else "<"
    u2 = np.dtype(bo + "u2")
    dt = np.dtype([
        ("year", u2), ("doy", u2), ("hour", "u1"), ("minute", "u1"),
        ("sec", "u1"), ("pad", "u1"), ("fract", u2), ("n_samp", u2),
        ("f", bo + "i2"), ("m", bo + "i2"), ("act", "u1"), ("pad2", "u1", 3),
        ("tcorr", bo + "i4"), ("data_ofs", u2), ("blk_ofs", u2)])
    h = np.ascontiguousarray(a[:, 20:_FIXED]).view(dt)[:, 0]
    rows = np.arange(n)

    def word(ofs):
        return np.ascontiguousarray(
            a[rows[:, None], ofs[:, None] + np.arange(2)]).view(u2)[:, 0]

    # walk each record's blockette chain for 1000, all records at once
    enc = np.full(n, 11, np.int64)
    word_big = np.ones(n, bool)
    exp = np.zeros(n, np.int64)
    ofs = h["blk_ofs"].astype(np.int64)
    while ofs.any():
        live = ofs > 0
        if (ofs[live] + 7 > rec_len).any():
            return None
        o = np.where(live, ofs, 0)
        btype, nxt = word(o).astype(np.int64), word(o + 2).astype(np.int64)
        is1000 = live & (btype == 1000)
        enc = np.where(is1000, a[rows, o + 4], enc)
        word_big = np.where(is1000, a[rows, o + 5] == 1, word_big)
        exp = np.where(is1000, a[rows, o + 6], exp)
        ofs = np.where(live & (nxt > ofs), nxt, 0)
    if (exp == 0).any() or ((np.int64(1) << exp) != rec_len).any():
        return None        # a record without blockette 1000, or another length
    bad = ~np.isin(enc, (1, 3, 4, 5, 10, 11))
    if bad.any():
        raise NotImplementedError(
            f"miniSEED encoding {int(enc[bad][0])} not supported")
    width = np.select([enc == 1, enc == 5, np.isin(enc, (3, 4))],
                      [2, 8, 4], 0)
    payload = np.maximum(rec_len - h["data_ofs"].astype(np.int64), 0)
    fixed = width > 0
    if (payload[fixed] % width[fixed]).any():
        raise ValueError("buffer size must be a multiple of element size")
    n_samp = h["n_samp"].astype(np.int64)
    n_data = np.where(fixed, np.minimum(n_samp, payload
                                        // np.maximum(width, 1)), n_samp)

    f, m = h["f"].astype(np.int64), h["m"].astype(np.int64)
    if ((f != 0) & (m == 0)).any():
        return None        # the record-by-record walk raises on it
    with np.errstate(divide="ignore", invalid="ignore"):
        ff, mf = f.astype(np.float64), m.astype(np.float64)
        sr = np.select(
            [(f > 0) & (m > 0), f > 0, (f < 0) & (m > 0), f < 0],
            [ff * mf, -ff / mf, -mf / ff, 1.0 / (ff * mf)], 0.0)
    days = ((h["year"].astype(np.int64) - 1970).astype("datetime64[Y]")
            .astype("datetime64[D]").astype(np.int64)
            + h["doy"].astype(np.int64) - 1)
    ns = ((((days * 24 + h["hour"]) * 60 + h["minute"]) * 60 + h["sec"])
          * 1_000_000_000 + h["fract"].astype(np.int64) * 100_000)
    tcorr = h["tcorr"].astype(np.int64)
    ns = ns + np.where(((h["act"] & 0x02) == 0) & (tcorr != 0),
                       tcorr * 100_000, 0)
    fields = dict(starttime=ns / 1e9, sampling_rate=sr, n_samp=n_samp,
                  n_data=n_data, encoding=enc, word_big=word_big,
                  data_ofs=h["data_ofs"].astype(np.int64),
                  rec_len=np.full(n, rec_len, np.int64))
    return _index_of(rows * rec_len, np.ascontiguousarray(a[:, 8:20]),
                     fields)


def _index(buf: bytes) -> _Index:
    if len(buf) < _FIXED:
        return _sequential_index(buf)
    return (_uniform_index(buf, _parse_header(buf, 0))
            or _sequential_index(buf))


def _epoch(t) -> float:
    return t if isinstance(t, (int, float)) else epoch_from_utc(t)


def _read_channel(buf: bytes, idx: _Index, c: int, starttime,
                  endtime) -> Trace:
    """Channel `c`'s records -> its trace, as `merge_fill` of all of them
    followed by `Trace.slice` would give it, decoding only the records
    that reach into the slice."""
    recs = np.flatnonzero(idx.channel == c)
    starts = idx.starttime[recs]
    n_data = idx.n_data[recs]
    sr = float(idx.sampling_rate[recs[0]])
    if len(recs) == 1:
        t0, n = float(starts[0]), int(n_data[0])
        offsets = np.zeros(1, np.int64)
    else:
        t0 = float(starts.min())
        t1 = float((starts + np.maximum(0, n_data - 1)
                    / idx.sampling_rate[recs]).max())
        n = int(round((t1 - t0) * sr)) + 1
        order = np.argsort(starts, kind="stable")
        recs, n_data = recs[order], n_data[order]
        offsets = np.round((starts[order] - t0) * sr).astype(np.int64)
    a, b = 0, n
    if starttime is not None:
        a = max(0, int(sec_to_samp(_epoch(starttime) - t0, sr=sr)))
    if endtime is not None:
        b = min(n, int(sec_to_samp(_epoch(endtime) - t0, sr=sr)) + 1)
    b = max(a, b)
    data = np.zeros(b - a, np.float32)
    written = np.zeros(b - a, bool)
    conflict = np.zeros(b - a, bool)
    lo = np.maximum(a, offsets)
    hi = np.minimum(b, offsets + n_data)
    for r in np.flatnonzero(lo < hi):
        k = recs[r]
        seg = _decode(buf, int(idx.pos[k]), int(idx.data_ofs[k]),
                      int(idx.rec_len[k]), int(idx.encoding[k]),
                      bool(idx.word_big[k]), int(idx.n_samp[k]))
        i0 = int(offsets[r])
        seg = seg.astype(np.float32)[lo[r] - i0: hi[r] - i0]
        sl = slice(lo[r] - a, hi[r] - a)
        conflict[sl] |= written[sl] & (data[sl] != seg)
        data[sl] = np.where(written[sl], data[sl], seg)
        written[sl] = True
    data[conflict] = 0.0
    net, sta, loc, cha = idx.ids[c]
    return Trace(data, station=sta, network=net, channel=cha, location=loc,
                 sampling_rate=sr, starttime=t0 + a / sr)


def read_mseed(path, starttime=None, endtime=None) -> Stream:
    """Read a miniSEED file into a Stream (contiguous records of the same
    channel are concatenated; gaps/overlaps merge with zero fill), cut to
    [starttime, endtime] as `Stream.slice` cuts.  The headers are read
    first; only the records that overlap the window are decoded."""
    with open(path, "rb") as fh:
        buf = fh.read()
    idx = _index(buf)
    return Stream([_read_channel(buf, idx, c, starttime, endtime)
                   for c in range(len(idx.ids))])


def merge_fill(stream: Stream, fill_value: float = 0.0) -> Stream:
    """Merge same-id trace segments onto a common time base, filling gaps
    (the reference's `obspy.Stream.merge(fill_value=0)` behavior): gaps
    get `fill_value`; overlap samples where the segments agree are kept
    (obspy's `_cleanup` pass), while conflicting overlap samples are
    discarded and replaced with `fill_value` (method-0 semantics)."""
    groups: Dict[str, List[Trace]] = {}
    for tr in stream:
        groups.setdefault(tr.id, []).append(tr)
    out = Stream()
    for trs in groups.values():
        if len(trs) == 1:
            out += trs[0]
            continue
        sr = trs[0].stats.sampling_rate
        t0 = min(tr.stats.starttime for tr in trs)
        t1 = max(tr.stats.endtime for tr in trs)
        n = int(round((t1 - t0) * sr)) + 1
        data = np.full(n, fill_value, np.float32)
        written = np.zeros(n, bool)
        conflict = np.zeros(n, bool)
        for tr in sorted(trs, key=lambda t: t.stats.starttime):
            i0 = int(round((tr.stats.starttime - t0) * sr))
            seg = np.asarray(tr.data, np.float32)
            sl = slice(i0, i0 + len(seg))
            conflict[sl] |= written[sl] & (data[sl] != seg)
            data[sl] = np.where(written[sl], data[sl], seg)
            written[sl] = True
        data[conflict] = fill_value
        merged = Trace(data, sampling_rate=sr, starttime=t0,
                       station=trs[0].stats.station,
                       network=trs[0].stats.network,
                       channel=trs[0].stats.channel,
                       location=trs[0].stats.location)
        out += merged
    return out


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_ENCODINGS = {"INT16": 1, "INT32": 3, "FLOAT32": 4, "STEIM1": 10,
              "STEIM2": 11}


def _btime(epoch: float) -> bytes:
    t = np.datetime64(int(round(epoch * 1e9)), "ns")
    y = t.astype("datetime64[Y]")
    year = int(str(y))
    doy = int((t.astype("datetime64[D]") - y.astype("datetime64[D]"))
              / np.timedelta64(1, "D")) + 1
    rem = t - t.astype("datetime64[D]").astype("datetime64[ns]")
    ns = int(rem / np.timedelta64(1, "ns"))
    hour, ns = divmod(ns, 3_600_000_000_000)
    minute, ns = divmod(ns, 60_000_000_000)
    sec, ns = divmod(ns, 1_000_000_000)
    fract = ns // 100_000
    return (year.to_bytes(2, "big") + doy.to_bytes(2, "big")
            + bytes([hour, minute, sec, 0]) + fract.to_bytes(2, "big"))


def write_mseed(stream: Stream, path: str, encoding: str = "STEIM2",
                record_length: int = 512):
    """Write a Stream as big-endian miniSEED records."""
    enc = _ENCODINGS[encoding.upper()]
    payload_len = record_length - 64
    seq = 1
    with open(path, "wb") as fh:
        for tr in stream:
            sr = tr.stats.sampling_rate
            # sample-rate factor/multiplier: integer rates directly,
            # sub-1Hz via negative factor
            if sr >= 1:
                f, m = int(round(sr)), 1
            else:
                f, m = -int(round(1.0 / sr)), 1
            if encoding.upper() in ("STEIM1", "STEIM2"):
                data = np.asarray(tr.data)
                if not np.issubdtype(data.dtype, np.integer):
                    data = np.round(data).astype(np.int64)
            elif encoding.upper() == "FLOAT32":
                data = np.asarray(tr.data, np.float32)
            else:
                data = np.round(np.asarray(tr.data)).astype(
                    np.int32 if enc == 3 else np.int16
                )
            i = 0
            t = tr.stats.starttime
            while i < len(data):
                if enc == 10 or enc == 11:
                    payload, n_rec = _encode_steim(
                        data[i:], payload_len // 64, steim2=(enc == 11)
                    )
                else:
                    width = {1: 2, 3: 4, 4: 4}[enc]
                    n_rec = min(payload_len // width, len(data) - i)
                    dt = {1: ">i2", 3: ">i4", 4: ">f4"}[enc]
                    payload = data[i : i + n_rec].astype(dt).tobytes()
                    payload += b"\x00" * (payload_len - len(payload))
                hdr = (
                    f"{seq % 1000000:06d}".encode() + b"D " +
                    f"{tr.stats.station:<5.5s}".encode() +
                    f"{tr.stats.location:<2.2s}".encode() +
                    f"{tr.stats.channel:<3.3s}".encode() +
                    f"{tr.stats.network:<2.2s}".encode() +
                    _btime(t) +
                    int(n_rec).to_bytes(2, "big") +
                    int(f).to_bytes(2, "big", signed=True) +
                    int(m).to_bytes(2, "big", signed=True) +
                    bytes([0, 0, 0, 1]) +      # flags + 1 blockette
                    (0).to_bytes(4, "big") +   # time correction
                    (64).to_bytes(2, "big") +  # data offset
                    (48).to_bytes(2, "big")    # first blockette
                )
                blk1000 = (
                    (1000).to_bytes(2, "big") + (0).to_bytes(2, "big")
                    + bytes([enc, 1, record_length.bit_length() - 1, 0])
                )
                fh.write(hdr + blk1000
                         + b"\x00" * (64 - _FIXED - len(blk1000)) + payload)
                i += n_rec
                t += n_rec / sr
                seq += 1
