"""Training log (port of ``vqvae_tpu/train/metrics.py``): one JSON record
per logged step in ``<out>/log.jsonl`` (the reference's metric names
loss/loss1/loss2/loss3), a console table, TensorBoard scalars in
``<out>/tb`` with ``tensorboard=True``, and a loss-curve PNG
(``plot()``) beside the log.

The JAX package writes its scalars through ``tf.summary`` and drops them
in silence when TensorFlow does not import.  Neither TensorFlow nor
TensorBoard is on the card's machine, so the port writes the event file
itself, in pure Python: TFRecord framing (a little-endian uint64
length, the masked CRC32C of those 8 bytes, the data, the masked CRC32C
of the data) around hand-encoded ``Event`` protobufs.  Each value is a
float32 ``simple_value`` (the ``Summary.Value`` field TensorBoard's
scalar dashboard reads alongside the tensors ``tf.summary.scalar``
writes).  A writer that cannot open its file raises: ``tensorboard=True``
is never dropped in silence.  ``read_events`` reads such a file back
(the tests and ``chip_smoke.py`` check the writer with it).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict, Iterable, List

import numpy as np


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    n = struct.pack("<Q", len(data))
    return (n + struct.pack("<I", masked_crc(n)) + data
            + struct.pack("<I", masked_crc(data)))


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int = 0,
                 file_version: str | None = None,
                 scalars: Dict[str, float] | None = None) -> bytes:
    """A ``tensorflow.Event``: wall_time (1, double), step (2, int64),
    file_version (3, string) or summary (5) of ``Summary.Value``s with
    tag (1) and float32 simple_value (2)."""
    out = b"\x09" + struct.pack("<d", wall_time)
    if step:
        out += b"\x10" + _varint(step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if scalars:
        with np.errstate(over="ignore"):    # past float32's range: inf
            summary = b"".join(
                _field_bytes(1, _field_bytes(1, tag.encode())
                             + b"\x15" + np.asarray(value, "<f4").tobytes())
                for tag, value in scalars.items())
        out += _field_bytes(5, summary)
    return out


def _fields(buf: bytes):
    """(field number, raw value) of each field of a protobuf message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield num, val


def _read_varint(buf: bytes, i: int):
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def read_events(path: str) -> List[dict]:
    """The events of a file ``EventWriter`` wrote, each as ``{"wall_time",
    "step", "file_version" (or None), "scalars": [(tag, float32 value)]}``;
    raises on a CRC mismatch or a truncated record."""
    events = []
    with open(path, "rb") as f:
        buf = f.read()
    i = 0
    while i < len(buf):
        if i + 12 > len(buf):
            raise ValueError(f"{path}: truncated record header at {i}")
        n = buf[i:i + 8]
        (length,) = struct.unpack("<Q", n)
        (crc,) = struct.unpack("<I", buf[i + 8:i + 12])
        if crc != masked_crc(n):
            raise ValueError(f"{path}: bad length CRC at {i}")
        data = buf[i + 12:i + 12 + length]
        end = i + 12 + length
        if len(data) != length or end + 4 > len(buf):
            raise ValueError(f"{path}: truncated record at {i}")
        (crc,) = struct.unpack("<I", buf[end:end + 4])
        if crc != masked_crc(data):
            raise ValueError(f"{path}: bad data CRC at {i}")
        i = end + 4
        ev = {"wall_time": 0.0, "step": 0, "file_version": None,
              "scalars": []}
        for num, val in _fields(data):
            if num == 1:
                ev["wall_time"] = struct.unpack("<d", val)[0]
            elif num == 2:
                ev["step"] = val
            elif num == 3:
                ev["file_version"] = val.decode()
            elif num == 5:
                for vnum, value in _fields(val):
                    if vnum != 1:
                        continue
                    tag, simple = None, None
                    for fnum, fval in _fields(value):
                        if fnum == 1:
                            tag = fval.decode()
                        elif fnum == 2:
                            simple = struct.unpack("<f", fval)[0]
                    ev["scalars"].append((tag, simple))
        events.append(ev)
    return events


class EventWriter:
    """Scalars into ``<logdir>/events.out.tfevents.<time>.<host>``, one
    ``Event`` a step; the file starts with ``file_version`` =
    ``brain.Event:2``.  Each ``add`` is flushed."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, "events.out.tfevents.%010d.%s" % (time.time(),
                                                      socket.gethostname()))
        self._f = open(self.path, "ab")
        self._write(encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._f.write(frame_record(event))
        self._f.flush()

    def add(self, step: int, scalars: Dict[str, float]) -> None:
        self._write(encode_event(time.time(), step, scalars=scalars))

    def close(self) -> None:
        self._f.close()


class MetricsLogger:
    def __init__(self, out_dir: str,
                 print_keys: Iterable[str] = ("loss", "loss1", "loss2",
                                              "loss3", "codebook_usage",
                                              "val_loss1"),
                 tensorboard: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "log.jsonl")
        self._f = open(self.path, "a")
        self.print_keys = list(print_keys)
        self._header = None            # the column set printed last
        self._t_last = time.time()
        self._step_last = None
        self._tb = (EventWriter(os.path.join(out_dir, "tb"))
                    if tensorboard else None)

    def log(self, step: int, metrics: Dict[str, float],
            echo: bool = True) -> None:
        now = time.time()
        rec = {"iteration": int(step),
               "elapsed": now - self._t_last,
               **{k: float(v) for k, v in metrics.items()}}
        # the train loop passes its StepTimer's steps_per_sec; callers
        # that log without a timer get the log interval's rate
        if ("steps_per_sec" not in rec and self._step_last is not None
                and now > self._t_last):
            rec["steps_per_sec"] = (step - self._step_last) / \
                (now - self._t_last)
        self._t_last, self._step_last = now, step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add(int(step), {k: v for k, v in rec.items()
                                     if k != "iteration"})
        if echo:
            self._echo(rec)

    def _echo(self, rec: Dict[str, float]) -> None:
        keys = ["iteration"] + [k for k in self.print_keys if k in rec]
        keys += [k for k in ("steps_per_sec",) if k in rec]
        # the header again whenever the column set changes (evaluation
        # rows add val_* columns on their own schedule)
        if keys != self._header:
            print("  ".join(f"{k:>14s}" for k in keys))
            self._header = keys
        print("  ".join(f"{rec[k]:14d}" if k == "iteration"
                        else f"{rec[k]:14.5f}" for k in keys), flush=True)

    def plot(self) -> None:
        """Loss curves as ``loss.png`` beside the log; nothing without
        matplotlib."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        steps, series = [], {}
        with open(self.path) as f:
            for line in f:
                rec = json.loads(line)
                steps.append(rec["iteration"])
                for k in ("loss1", "loss2", "loss3"):
                    if k in rec:
                        series.setdefault(k, []).append(rec[k])
        if not steps:
            return
        fig, ax = plt.subplots()
        for k, v in series.items():
            ax.plot(steps[:len(v)], v, label=k)
        ax.set_xlabel("iteration")
        ax.legend()
        fig.savefig(os.path.join(os.path.dirname(self.path), "loss.png"))
        plt.close(fig)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._f.close()
