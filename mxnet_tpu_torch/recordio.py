"""RecordIO for the port (≙ ``mxnet_tpu/recordio.py``): ``MXRecordIO``
(sequential), ``MXIndexedRecordIO`` (random access through a ``.idx``
of key and byte offset), and the ``IRHeader`` ``pack`` / ``unpack``
helpers of labelled image records (format ``IfQQ``: flag, float label,
id, id2; a vector label follows the header with flag = its length).

Plain Python file I/O, byte for byte the files of the reference's native
writer (``src/recordio.cc``): each record is ``<u32 magic> <u32 lrec>``,
the payload and zero padding to 4 bytes, where ``lrec`` holds a 3-bit
continuation flag; a payload holding the magic word at a 4-byte-aligned
offset is split there into chunks flagged 1 (first), 2 (middle) and 3
(last), the magic dropped and put back by the reader.
"""
from __future__ import annotations

import io as _io
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)
_MAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", _MAGIC)
_LEN_MASK = (1 << 29) - 1


def _chunks(buf: bytes):
    """(cflag, chunk) of a payload split at its 4-byte-aligned magics."""
    cuts = [i for i in range(0, len(buf) - 3, 4)
            if buf[i:i + 4] == _MAGIC_BYTES]
    if not cuts:
        return [(0, buf)]
    out, start = [], 0
    for k, cut in enumerate(cuts + [len(buf)]):
        cflag = 1 if k == 0 else (3 if k == len(cuts) else 2)
        out.append((cflag, buf[start:cut]))
        start = cut + 4
    return out


class MXRecordIO:
    """Sequential RecordIO reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.writable = flag == "w"
        self.is_open = False
        self._file = None
        self.open()

    def open(self):
        self._file = open(self.uri, "wb" if self.writable else "rb")
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        self._file.close()
        self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except (AttributeError, OSError):
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def write(self, buf: bytes):
        if not self.writable:
            raise IOError("MXRecordIO opened for reading")
        buf = bytes(buf)
        f = self._file
        for cflag, chunk in _chunks(buf):
            f.write(struct.pack("<II", _MAGIC,
                                (cflag << 29) | (len(chunk) & _LEN_MASK)))
            f.write(chunk)
            pad = (4 - (len(chunk) & 3)) & 3
            if pad:
                f.write(b"\x00" * pad)
        f.flush()

    def read(self):
        """The next record's payload (chunks reassembled), or None at the
        end of the file."""
        if self.writable:
            raise IOError("MXRecordIO opened for writing")
        parts = []
        in_multi = False
        while True:
            hdr = self._file.read(8)
            if len(hdr) < 8:
                if in_multi:
                    raise IOError("truncated multipart record")
                return None
            magic, lrec = struct.unpack("<II", hdr)
            if magic != _MAGIC:
                raise IOError("invalid RecordIO magic")
            cflag = (lrec >> 29) & 7
            length = lrec & _LEN_MASK
            data = self._file.read(length)
            if len(data) < length:
                raise IOError("truncated RecordIO payload")
            pad = (4 - (length & 3)) & 3
            if pad:
                self._file.read(pad)
            if cflag == 0:
                return data
            if cflag == 1:
                in_multi = True
                parts.append(data)
                continue
            if not in_multi:
                raise IOError("orphan RecordIO continuation")
            parts.append(_MAGIC_BYTES)
            parts.append(data)
            if cflag == 3:
                return b"".join(parts)

    def tell(self):
        return self._file.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with a text ``.idx`` of ``key\\toffset``
    lines."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            self.fidx = open(self.idx_path, "w")
        elif os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        if self.writable:
            raise IOError("MXIndexedRecordIO opened for writing")
        self._file.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.fidx.flush()
        self.idx[key] = pos
        self.keys.append(key)


# ------------------------------------------------------------- IR packing
def pack(header: IRHeader, s: bytes) -> bytes:
    """A record of ``header`` and payload ``s``."""
    header = IRHeader(*header)
    if isinstance(header.label, (float, int)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label),
                          header.id, header.id2)
        return hdr + s
    label = np.asarray(header.label, dtype=np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s: bytes):
    """(IRHeader, payload) of a record."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        arr = np.frombuffer(s[: flag * 4], dtype=np.float32)
        return IRHeader(flag, arr, id_, id2), s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def _has_encoder(img_fmt):
    """Whether the decode stage can encode ``img_fmt`` here."""
    from .image import decoder_info
    try:
        info = decoder_info()
    except RuntimeError:        # the stage does not build on this machine
        return False
    if img_fmt in (".jpg", ".jpeg"):
        return info["jpeg"] != "none"
    return img_fmt == ".png" and info["png"]


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an image and pack it with ``header`` (≙ ``pack_img``).  As
    with OpenCV, a 3-channel ``img`` is BGR.  The decode stage's encoder
    makes the payload (JPEG at ``quality``, or PNG); where it has none
    for ``img_fmt``, the payload is the array's ``.npy`` bytes, as the
    reference's without OpenCV."""
    arr = np.asarray(img)
    if _has_encoder(img_fmt):
        from .image import imencode
        if arr.ndim == 3 and arr.shape[2] >= 3:
            arr = arr[:, :, [2, 1, 0] + list(range(3, arr.shape[2]))]
        return pack(header, imencode(arr, img_fmt, quality))
    bio = _io.BytesIO()
    np.save(bio, arr, allow_pickle=False)
    return pack(header, bio.getvalue())


def unpack_img(s, iscolor=-1):
    """(IRHeader, image array) of a record (≙ ``unpack_img``): a ``.npy``
    payload as it was saved, an encoded one decoded to BGR as OpenCV's
    ``imdecode(buf, iscolor)`` gives it."""
    header, payload = unpack(s)
    if payload[:6] == b"\x93NUMPY":
        return header, np.load(_io.BytesIO(payload), allow_pickle=False)
    from .image import imdecode
    return header, imdecode(payload, to_rgb=False, flag=iscolor)
