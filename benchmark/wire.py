"""The drone pair's wire, as the replay clients speak it (a copy of the
framing of the port's ``serve/protocol.py``, which copies the JAX
package's): little-endian ``[u32 magic 0xA19B0001][u8 type][u32 length]
[payload]``.

  IMAGE  (1): u32 robot_id | u32 frame_id | f32 bb[3] | f32 init_trans[3] |
              u32 h | u32 w | u8 rgb[h·w·3]
  RESULT (4): u32 frame_id | f32 data[145] = betas[10] | trans·0.05 [3] | 6D pose[132]
"""

import struct
from typing import Optional, Tuple

import numpy as np

MAGIC = 0xA19B0001
MSG_IMAGE, MSG_STEP1, MSG_STEP2, MSG_RESULT, MSG_HELLO = 1, 2, 3, 4, 5
WIRE_FLOATS = 145
_HEADER = struct.Struct("<IBI")


def frame(msg_type: int, payload: bytes) -> bytes:
    return _HEADER.pack(MAGIC, msg_type, len(payload)) + payload


def encode_image(robot_id: int, frame_id: int, bb: np.ndarray, init_trans: np.ndarray,
                 image_u8: np.ndarray) -> bytes:
    h, w = image_u8.shape[:2]
    return frame(MSG_IMAGE, struct.pack("<II", robot_id, frame_id)
                 + np.asarray(bb, np.float32).tobytes()
                 + np.asarray(init_trans, np.float32).tobytes()
                 + struct.pack("<II", h, w)
                 + np.ascontiguousarray(image_u8, dtype=np.uint8).tobytes())


def decode_step(payload: bytes) -> Tuple[int, np.ndarray]:
    if len(payload) != 4 + 4 * WIRE_FLOATS:
        raise ValueError(f"a step payload is {4 + 4 * WIRE_FLOATS} bytes, not {len(payload)}")
    (frame_id,) = struct.unpack_from("<I", payload, 0)
    return frame_id, np.frombuffer(payload, np.float32, WIRE_FLOATS, 4).copy()


async def read_message(reader) -> Optional[Tuple[int, bytes]]:
    """One framed message from an asyncio stream; None at the end of it."""
    try:
        header = await reader.readexactly(_HEADER.size)
        magic, msg_type, length = _HEADER.unpack(header)
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic:#x}")
        return msg_type, (await reader.readexactly(length) if length else b"")
    except (ConnectionError, EOFError, OSError):
        return None
    except Exception as e:  # asyncio.IncompleteReadError is an EOFError
        if type(e).__name__ == "IncompleteReadError":
            return None
        raise
