"""Typed content handlers: image/audio/video metadata + archive expansion.

Parity: src/content/ (content_handler_registry.cpp routing;
image_content_handler.cpp PNG/JPEG/GIF/BMP dimension + EXIF parsing;
audio_content_handler.cpp WAV/ID3 header analysis; video_content_handler.cpp
MP4 metadata; archive_content_handler.cpp entry listing) — reimplemented from
the file-format specs on stdlib only. `extract_typed_metadata` returns flat
string metadata for the metadata table; `iter_archive_members` yields
(member_name, bytes) for zip/tar so ingestion can index members as child
documents (reference: extractFileList + entries).

Copied from yams_tpu/ingest/content_handlers.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import io
import struct
import tarfile
import zipfile
from collections.abc import Iterator

# zip-bomb guards (reference bounds its archive processing similarly)
MAX_MEMBERS = 256
MAX_MEMBER_BYTES = 32 * 1024 * 1024
MAX_TOTAL_BYTES = 128 * 1024 * 1024

ARCHIVE_MIMES = {
    "application/zip", "application/x-tar", "application/gzip",
    "application/x-bzip2", "application/x-xz",
}


# -- images ---------------------------------------------------------------------

def _png_meta(data: bytes) -> dict[str, str]:
    # IHDR is always the first chunk: length(4) 'IHDR' w(4) h(4) depth color
    if len(data) < 33 or data[12:16] != b"IHDR":
        return {}
    w, h = struct.unpack(">II", data[16:24])
    depth, color = data[24], data[25]
    color_types = {0: "gray", 2: "rgb", 3: "palette", 4: "gray+alpha", 6: "rgba"}
    return {"width": str(w), "height": str(h), "bit_depth": str(depth),
            "color_type": color_types.get(color, str(color))}


def _jpeg_meta(data: bytes) -> dict[str, str]:
    out: dict[str, str] = {}
    i = 2
    n = len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seglen = struct.unpack(">H", data[i + 2:i + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            # SOFn: precision(1) height(2) width(2)
            if i + 9 <= n:
                h, w = struct.unpack(">HH", data[i + 5:i + 9])
                out["width"], out["height"] = str(w), str(h)
            break
        if marker == 0xE1 and data[i + 4:i + 10] == b"Exif\x00\x00":
            out.update(_exif_meta(data[i + 10:i + 2 + seglen]))
        if marker == 0xDA:  # start of scan — no SOF found before
            break
        i += 2 + seglen
    return out


_EXIF_TAGS = {
    0x010F: "exif_make", 0x0110: "exif_model", 0x0112: "exif_orientation",
    0x0132: "exif_datetime", 0x8769: None,  # ExifIFD pointer
    0x829A: "exif_exposure_time", 0x8827: "exif_iso",
    0x920A: "exif_focal_length", 0x9003: "exif_datetime_original",
}


def _exif_meta(tiff: bytes) -> dict[str, str]:
    """Minimal TIFF-IFD walk for the common EXIF tags (orientation, make,
    model, timestamps) — the subset the reference surfaces."""
    out: dict[str, str] = {}
    if len(tiff) < 8:
        return out
    end = "<" if tiff[:2] == b"II" else ">" if tiff[:2] == b"MM" else None
    if end is None:
        return out

    def u16(o):
        return struct.unpack(end + "H", tiff[o:o + 2])[0]

    def u32(o):
        return struct.unpack(end + "I", tiff[o:o + 4])[0]

    def read_ifd(off, depth=0):
        if depth > 2 or off + 2 > len(tiff):
            return
        count = u16(off)
        for k in range(count):
            e = off + 2 + k * 12
            if e + 12 > len(tiff):
                return
            tag, typ = u16(e), u16(e + 2)
            cnt = u32(e + 4)
            if tag not in _EXIF_TAGS:
                continue
            size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 10: 8}.get(typ, 1) * cnt
            voff = e + 8 if size <= 4 else u32(e + 8)
            if voff + size > len(tiff):
                continue
            if _EXIF_TAGS[tag] is None:  # sub-IFD pointer
                read_ifd(u32(e + 8), depth + 1)
                continue
            if typ == 2:      # ASCII
                val = tiff[voff:voff + cnt].split(b"\x00")[0].decode(
                    "ascii", "replace").strip()
            elif typ == 3:
                val = str(u16(voff))
            elif typ == 4:
                val = str(u32(voff))
            elif typ in (5, 10):  # rational
                num, den = u32(voff), u32(voff + 4)
                val = f"{num}/{den}" if den else str(num)
            else:
                continue
            if val:
                out[_EXIF_TAGS[tag]] = val

    read_ifd(u32(4))
    return out


def _gif_meta(data: bytes) -> dict[str, str]:
    if len(data) < 10:
        return {}
    w, h = struct.unpack("<HH", data[6:10])
    return {"width": str(w), "height": str(h)}


def _bmp_meta(data: bytes) -> dict[str, str]:
    if len(data) < 26:
        return {}
    w, h = struct.unpack("<ii", data[18:26])
    return {"width": str(w), "height": str(abs(h))}


def _webp_meta(data: bytes) -> dict[str, str]:
    if len(data) < 30 or data[8:12] != b"WEBP":
        return {}
    fmt = data[12:16]
    if fmt == b"VP8X":
        w = 1 + (data[24] | data[25] << 8 | data[26] << 16)
        h = 1 + (data[27] | data[28] << 8 | data[29] << 16)
    elif fmt == b"VP8L":
        bits = struct.unpack("<I", data[21:25])[0]
        w = (bits & 0x3FFF) + 1
        h = ((bits >> 14) & 0x3FFF) + 1
    elif fmt == b"VP8 ":
        w = struct.unpack("<H", data[26:28])[0] & 0x3FFF
        h = struct.unpack("<H", data[28:30])[0] & 0x3FFF
    else:
        return {}
    return {"width": str(w), "height": str(h)}


# -- audio ----------------------------------------------------------------------

def _wav_meta(data: bytes) -> dict[str, str]:
    if len(data) < 44 or data[8:12] != b"WAVE":
        return {}
    i = 12
    out: dict[str, str] = {"codec": "PCM"}
    data_size = 0
    byte_rate = 0
    while i + 8 <= len(data):
        cid = data[i:i + 4]
        csize = struct.unpack("<I", data[i + 4:i + 8])[0]
        if cid == b"fmt " and i + 24 <= len(data):
            _, channels, rate, byte_rate, _, bits = struct.unpack(
                "<HHIIHH", data[i + 8:i + 24])
            out.update({"channels": str(channels), "sample_rate": str(rate),
                        "bits_per_sample": str(bits)})
        elif cid == b"data":
            data_size = csize
        i += 8 + csize + (csize & 1)
    if byte_rate and data_size:
        out["duration_s"] = f"{data_size / byte_rate:.3f}"
    return out


def _mp3_meta(data: bytes) -> dict[str, str]:
    """ID3v2 text frames (title/artist/album/year) + first MPEG frame header."""
    out: dict[str, str] = {"codec": "MP3"}
    pos = 0
    if data[:3] == b"ID3" and len(data) > 10:
        size = ((data[6] & 0x7F) << 21 | (data[7] & 0x7F) << 14
                | (data[8] & 0x7F) << 7 | (data[9] & 0x7F))
        frames = data[10:10 + size]
        names = {b"TIT2": "title", b"TPE1": "artist", b"TALB": "album",
                 b"TYER": "year", b"TDRC": "year"}
        j = 0
        while j + 10 <= len(frames):
            fid = frames[j:j + 4]
            fsz = struct.unpack(">I", frames[j + 4:j + 8])[0]
            if not fid.strip(b"\x00") or fsz <= 0 or fsz > len(frames):
                break
            if fid in names and fsz > 1:
                raw = frames[j + 10:j + 10 + fsz]
                enc = raw[0]
                txt = raw[1:].decode(
                    "utf-16" if enc in (1, 2) else "utf-8", "replace"
                ).strip("\x00").strip()
                if txt:
                    out[names[fid]] = txt
            j += 10 + fsz
        pos = 10 + size
    # first frame header: sample rate + bitrate
    rates = {0: 44100, 1: 48000, 2: 32000}
    for k in range(pos, min(len(data) - 4, pos + 4096)):
        b0, b1, b2 = data[k], data[k + 1], data[k + 2]
        if b0 == 0xFF and (b1 & 0xE0) == 0xE0 and (b1 & 0x18) == 0x18:
            sr = rates.get((b2 >> 2) & 0x3)
            if sr:
                out["sample_rate"] = str(sr)
            break
    return out


def _flac_meta(data: bytes) -> dict[str, str]:
    # STREAMINFO is the first metadata block after 'fLaC'
    if len(data) < 42 or data[4] & 0x7F != 0:
        return {}
    si = data[8:42]
    rate = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4)
    channels = ((si[12] >> 1) & 0x7) + 1
    bits = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1
    total = ((si[13] & 0x0F) << 32 | si[14] << 24 | si[15] << 16
             | si[16] << 8 | si[17])
    out = {"codec": "FLAC", "sample_rate": str(rate),
           "channels": str(channels), "bits_per_sample": str(bits)}
    if rate and total:
        out["duration_s"] = f"{total / rate:.3f}"
    return out


# -- video ----------------------------------------------------------------------

def _mp4_meta(data: bytes) -> dict[str, str]:
    """Walk top-level boxes to moov/mvhd (duration) + trak/tkhd (dims)."""
    out: dict[str, str] = {}

    def walk(buf: bytes, start: int, end: int, depth: int = 0) -> None:
        i = start
        while i + 8 <= end and depth < 6:
            size = struct.unpack(">I", buf[i:i + 4])[0]
            typ = buf[i + 4:i + 8]
            if size == 1 and i + 16 <= end:
                size = struct.unpack(">Q", buf[i + 8:i + 16])[0]
            if size < 8:
                return
            body = i + 8
            if typ in (b"moov", b"trak", b"mdia"):
                walk(buf, body, min(i + size, end), depth + 1)
            elif typ == b"mvhd" and body + 20 <= end:
                ver = buf[body]
                if ver == 1:
                    scale = struct.unpack(">I", buf[body + 20:body + 24])[0]
                    dur = struct.unpack(">Q", buf[body + 24:body + 32])[0]
                else:
                    scale = struct.unpack(">I", buf[body + 12:body + 16])[0]
                    dur = struct.unpack(">I", buf[body + 16:body + 20])[0]
                if scale:
                    out["duration_s"] = f"{dur / scale:.3f}"
            elif typ == b"tkhd" and i + size <= end:
                w = struct.unpack(">I", buf[i + size - 8:i + size - 4])[0] >> 16
                h = struct.unpack(">I", buf[i + size - 4:i + size])[0] >> 16
                if w and h:
                    out.setdefault("width", str(w))
                    out.setdefault("height", str(h))
            elif typ == b"ftyp":
                out.setdefault(
                    "brand", buf[body:body + 4].decode("ascii", "replace"))
            i += size

    walk(data, 0, len(data))
    if out:
        out["codec"] = "MP4"
    return out


# -- registry -------------------------------------------------------------------

_HANDLERS = {
    "image/png": _png_meta,
    "image/jpeg": _jpeg_meta,
    "image/gif": _gif_meta,
    "image/bmp": _bmp_meta,
    "image/webp": _webp_meta,
    "audio/wav": _wav_meta,
    "audio/x-wav": _wav_meta,
    "audio/mpeg": _mp3_meta,
    "audio/flac": _flac_meta,
    "video/mp4": _mp4_meta,
}


def extract_typed_metadata(data: bytes, mime: str) -> dict[str, str]:
    """Flat {key: str} typed metadata for a blob, or {} when unhandled."""
    fn = _HANDLERS.get(mime)
    if fn is None:
        return {}
    try:
        out = fn(data)
    except (struct.error, IndexError, ValueError):
        return {}
    if out:
        out["media_type"] = mime.split("/", 1)[0]
    return out


# -- archives -------------------------------------------------------------------

def is_archive_mime(mime: str) -> bool:
    return mime in ARCHIVE_MIMES


def iter_archive_members(
    data: bytes, mime: str, name: str = "",
) -> Iterator[tuple[str, bytes]]:
    """Yield (member_path, member_bytes) for zip and tar(.gz/.bz2/.xz)
    archives, bounded by MAX_MEMBERS / MAX_MEMBER_BYTES / MAX_TOTAL_BYTES
    (zip-bomb guard). Non-archive or unparseable input yields nothing.

    Plain .gz/.bz2/.xz of a single file yields that one decompressed member
    unless it wraps a tar (then the tar expands).
    """
    total = 0

    def bounded(payload: bytes, member: str):
        nonlocal total
        if len(payload) > MAX_MEMBER_BYTES:
            return None
        total += len(payload)
        if total > MAX_TOTAL_BYTES:
            raise _Stop()
        # zip paths can be absolute or traversal-laden: normalize
        member = member.replace("\\", "/").lstrip("/")
        while member.startswith("../"):
            member = member[3:]
        return member, payload

    class _Stop(Exception):
        pass

    try:
        if mime == "application/zip":
            with zipfile.ZipFile(io.BytesIO(data)) as zf:
                for info in zf.infolist()[:MAX_MEMBERS]:
                    if info.is_dir() or info.file_size > MAX_MEMBER_BYTES:
                        continue
                    item = bounded(zf.read(info), info.filename)
                    if item:
                        yield item
            return
        if mime in ("application/x-tar", "application/gzip",
                    "application/x-bzip2", "application/x-xz"):
            try:
                with tarfile.open(fileobj=io.BytesIO(data), mode="r:*") as tf:
                    n = 0
                    for info in tf:
                        if not info.isfile() or info.size > MAX_MEMBER_BYTES:
                            continue
                        f = tf.extractfile(info)
                        if f is None:
                            continue
                        item = bounded(f.read(), info.name)
                        if item:
                            yield item
                        n += 1
                        if n >= MAX_MEMBERS:
                            break
                return
            except tarfile.TarError:
                pass
            # plain compressed single file — stream-decompress with a hard
            # output cap: decompress-then-check would let a few-MB bomb
            # inflate to tens of GB before the bound ever ran
            import bz2
            import gzip
            import lzma

            opener = {
                "application/gzip": lambda b: gzip.GzipFile(fileobj=b),
                "application/x-bzip2": lambda b: bz2.BZ2File(b),
                "application/x-xz": lambda b: lzma.LZMAFile(b),
            }.get(mime)
            if opener is not None:
                with opener(io.BytesIO(data)) as f:
                    payload = f.read(MAX_MEMBER_BYTES + 1)
                if len(payload) > MAX_MEMBER_BYTES:
                    return  # oversized member: store archive as-is
                inner = name.rsplit("/", 1)[-1]
                for suf in (".gz", ".bz2", ".xz"):
                    if inner.endswith(suf):
                        inner = inner[:-len(suf)]
                inner = inner or "decompressed"
                item = bounded(payload, inner)
                if item:
                    yield item
    except _Stop:
        return
    except Exception:
        # any parse failure on adversarial input yields no members — the
        # archive is still stored as a plain document (zipfile/tarfile raise
        # a wide range: BadZipFile, TarError, NotImplementedError on fuzzed
        # version fields, zlib/lzma errors, struct.error, OSError...)
        return
