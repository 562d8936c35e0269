"""Wire protocol for the two-drone 3-step synchronization (copy of
airpose_tpu/serve/protocol.py: the same bytes on the wire).

The 145-float parameter message preserves the reference's format exactly
(ref copenet_real/scripts/copenet_rosViz.py:83-85, README topic docs):

    data[0:10]   = betas
    data[10:13]  = camera-frame translation × TRANS_SCALE (0.05)
    data[13:145] = 22 × 6D rotation (root orient + 21 body joints)

Framing (this framework's TCP transport, replacing ROS topics + the aircap
client's ad-hoc stream — SURVEY.md §2.8/§2.9): little-endian

    [u32 magic=0xA19B0001][u8 type][u32 payload_len][payload]

    type 1 IMAGE : u32 robot_id | u32 frame_id | f32 bb[3] |
                   f32 init_trans[3] | u32 h | u32 w | u8 rgb[h*w*3]
    type 2 STEP1 : u32 frame_id | f32 data[145]
    type 3 STEP2 : u32 frame_id | f32 data[145]
    type 4 RESULT: u32 frame_id | f32 data[145]     (the step3 output)
    type 5 HELLO : u32 robot_id                     (tags a peer link)

The same protocol library is implemented in C++ under native/ for the
drone-side client, which serves against this package's servers unchanged.
"""

import struct
from typing import Optional, Tuple

import numpy as np

from .. import constants as C

MAGIC = 0xA19B0001
MSG_IMAGE = 1
MSG_STEP1 = 2
MSG_STEP2 = 3
MSG_RESULT = 4
MSG_HELLO = 5  # peer-link handshake: payload = u32 robot_id

_HEADER = struct.Struct("<IBI")

# Largest legal payload. Bounds what the readers will buffer for one
# message, so a corrupt/hostile length prefix (u32 → up to 4 GB) cannot
# exhaust server memory: a 1024×1024 RGB frame message is ~3 MB, 64 MB
# leaves wide margin for any legitimate message.
MAX_PAYLOAD = 1 << 26

# Largest legal IMAGE side. The served crop is IMG_RES (224); 2048 leaves
# wide margin for any legitimate client while keeping a hostile
# well-framed IMAGE from forcing multi-GB device buffers (the server also
# pins the crop shape to the first frame it serves).
MAX_IMAGE_DIM = 2048


class ProtocolError(ValueError):
    """Malformed wire data (bad framing or inconsistent payload). Servers
    treat this as a broken connection — log and close — never a crash."""


def pack_params(betas: np.ndarray, trans: np.ndarray, pose6d: np.ndarray) -> np.ndarray:
    """(10,), (3,) unscaled camera-frame translation, (132,) 6D pose →
    (145,) wire floats."""
    data = np.empty(C.WIRE_NUM_FLOATS, np.float32)
    data[0:10] = betas
    data[10:13] = np.asarray(trans) * C.TRANS_SCALE
    data[13:145] = pose6d
    return data


def unpack_params(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(145,) → (betas (10,), trans (3,) unscaled, pose6d (132,))."""
    data = np.asarray(data, np.float32)
    return data[0:10], data[10:13] / C.TRANS_SCALE, data[13:145]


def frame(msg_type: int, payload: bytes) -> bytes:
    return _HEADER.pack(MAGIC, msg_type, len(payload)) + payload


def encode_image(robot_id: int, frame_id: int, bb: np.ndarray,
                 init_trans: np.ndarray, image_u8: np.ndarray) -> bytes:
    h, w = image_u8.shape[:2]
    payload = (
        struct.pack("<II", robot_id, frame_id)
        + np.asarray(bb, np.float32).tobytes()
        + np.asarray(init_trans, np.float32).tobytes()
        + struct.pack("<II", h, w)
        + np.ascontiguousarray(image_u8, dtype=np.uint8).tobytes()
    )
    return frame(MSG_IMAGE, payload)


def decode_image(payload: bytes):
    if len(payload) < 40:
        raise ProtocolError(f"IMAGE payload too short ({len(payload)} bytes)")
    robot_id, frame_id = struct.unpack_from("<II", payload, 0)
    bb = np.frombuffer(payload, np.float32, 3, 8)
    init_trans = np.frombuffer(payload, np.float32, 3, 20)
    h, w = struct.unpack_from("<II", payload, 32)
    if h == 0 or w == 0 or h > MAX_IMAGE_DIM or w > MAX_IMAGE_DIM \
            or len(payload) != 40 + h * w * 3:
        raise ProtocolError(
            f"IMAGE dims {h}x{w} inconsistent with payload "
            f"({len(payload)} bytes) or beyond {MAX_IMAGE_DIM}px")
    img = np.frombuffer(payload, np.uint8, h * w * 3, 40).reshape(h, w, 3)
    return robot_id, frame_id, bb, init_trans, img


def encode_step(msg_type: int, frame_id: int, data: np.ndarray) -> bytes:
    assert data.shape == (C.WIRE_NUM_FLOATS,)
    payload = struct.pack("<I", frame_id) + np.asarray(data, np.float32).tobytes()
    return frame(msg_type, payload)


def decode_step(payload: bytes):
    if len(payload) != 4 + 4 * C.WIRE_NUM_FLOATS:
        raise ProtocolError(f"step payload is {len(payload)} bytes, "
                            f"want {4 + 4 * C.WIRE_NUM_FLOATS}")
    (frame_id,) = struct.unpack_from("<I", payload, 0)
    data = np.frombuffer(payload, np.float32, C.WIRE_NUM_FLOATS, 4)
    return frame_id, data


async def read_message(reader) -> Optional[Tuple[int, bytes]]:
    """Read one framed message from an asyncio StreamReader; None on EOF
    (including a connection dropped mid-message). Raises ProtocolError on
    bad framing — the stream is unrecoverable past that point (no resync
    marker), so callers close the connection."""
    try:
        header = await reader.readexactly(_HEADER.size)
    except Exception:
        return None
    magic, msg_type, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic:#x}")
    if length > MAX_PAYLOAD:
        raise ProtocolError(f"payload length {length} exceeds {MAX_PAYLOAD}")
    try:
        payload = await reader.readexactly(length) if length else b""
    except Exception:
        return None
    return msg_type, payload


def read_message_sync(sock) -> Optional[Tuple[int, bytes]]:
    """Blocking-socket variant for simple clients/tests."""
    def recv_all(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    header = recv_all(_HEADER.size)
    if header is None:
        return None
    magic, msg_type, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic:#x}")
    if length > MAX_PAYLOAD:
        raise ProtocolError(f"payload length {length} exceeds {MAX_PAYLOAD}")
    payload = recv_all(length) if length else b""
    if payload is None:  # connection dropped mid-message: EOF
        return None
    return msg_type, payload
