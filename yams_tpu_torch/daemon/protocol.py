"""Daemon IPC: length-framed, CRC-checked msgpack messages over AF_UNIX.

Parity: include/yams/daemon/ipc/message_framing.h:34-114 — magic, version,
CRC32, length framing; the reference's ~50 typed request structs
(ipc_protocol_requests.h) become msgpack dicts {"id", "type", ...} with the
same request-type vocabulary. Payloads above CHUNK_THRESHOLD stream as
continuation frames (FLAG_MORE), mirroring the reference's chunked streaming
responses.

Copied from yams_tpu/daemon/protocol.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import struct
import zlib

import msgpack

MAGIC = 0x59545044  # "YTPD"
VERSION = 1
HEADER = struct.Struct("<IBBHII")  # magic, version, flags, reserved, length, crc
FLAG_MORE = 0x01  # continuation frame follows
FLAG_JSON = 0x02  # payload is UTF-8 JSON (C/mobile clients); bytes ride base64
                  # in {"__b64__": ...} wrappers. Replies mirror the flag.

MAX_FRAME = 256 * 1024 * 1024
CHUNK_SIZE = 4 * 1024 * 1024


class FrameError(Exception):
    pass


def _json_default(obj):
    import base64

    if isinstance(obj, (bytes, bytearray)):
        return {"__b64__": base64.b64encode(bytes(obj)).decode()}
    raise TypeError(f"not JSON-serializable: {type(obj)}")


def _json_revive(obj):
    import base64

    if isinstance(obj, dict):
        if set(obj) == {"__b64__"}:
            return base64.b64decode(obj["__b64__"])
        return {k: _json_revive(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_revive(v) for v in obj]
    return obj


def encode_frames(message: dict, json_mode: bool = False) -> bytes:
    if json_mode:
        import json

        payload = json.dumps(message, default=_json_default).encode()
        base_flags = FLAG_JSON
    else:
        payload = msgpack.packb(message, use_bin_type=True)
        base_flags = 0
    out = bytearray()
    offset = 0
    while True:
        chunk = payload[offset : offset + CHUNK_SIZE]
        offset += len(chunk)
        flags = base_flags | (FLAG_MORE if offset < len(payload) else 0)
        out += HEADER.pack(
            MAGIC, VERSION, flags, 0, len(chunk), zlib.crc32(chunk) & 0xFFFFFFFF
        )
        out += chunk
        if not (flags & FLAG_MORE):
            break
    return bytes(out)


def decode_header(raw: bytes) -> tuple[int, int]:
    """-> (payload length, flags); raises FrameError on a bad header."""
    magic, version, flags, _, length, crc = HEADER.unpack(raw)
    if magic != MAGIC:
        raise FrameError(f"bad magic 0x{magic:08x}")
    if version != VERSION:
        raise FrameError(f"unsupported protocol version {version}")
    if length > MAX_FRAME:
        raise FrameError(f"frame too large: {length}")
    return length, flags


def check_crc(raw: bytes, payload: bytes) -> None:
    crc = HEADER.unpack(raw)[5]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise FrameError("payload CRC mismatch")


# -- blocking (client) ----------------------------------------------------------

def write_frame(sock, message: dict) -> None:
    sock.sendall(encode_frames(message))


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise FrameError("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


def read_frame(sock) -> dict:
    payload = bytearray()
    while True:
        head = _recv_exact(sock, HEADER.size)
        length, flags = decode_header(head)
        part = _recv_exact(sock, length)
        check_crc(head, part)
        payload += part
        if not (flags & FLAG_MORE):
            break
        if len(payload) > MAX_FRAME:
            raise FrameError("stream too large")
    return msgpack.unpackb(bytes(payload), raw=False)


# -- asyncio (server) -------------------------------------------------------------

async def async_read_frame_ex(reader) -> tuple[dict, bool]:
    """-> (message, json_mode)."""
    payload = bytearray()
    json_mode = False
    while True:
        head = await reader.readexactly(HEADER.size)
        length, flags = decode_header(head)
        json_mode = bool(flags & FLAG_JSON)
        part = await reader.readexactly(length)
        check_crc(head, part)
        payload += part
        if not (flags & FLAG_MORE):
            break
        if len(payload) > MAX_FRAME:
            raise FrameError("stream too large")
    if json_mode:
        import json

        return _json_revive(json.loads(bytes(payload))), True
    return msgpack.unpackb(bytes(payload), raw=False), False


async def async_read_frame(reader) -> dict:
    msg, _ = await async_read_frame_ex(reader)
    return msg


async def async_write_frame(writer, message: dict, json_mode: bool = False) -> None:
    writer.write(encode_frames(message, json_mode=json_mode))
    await writer.drain()
