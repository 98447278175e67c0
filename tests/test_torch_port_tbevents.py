"""The port's TensorBoard events against the JAX package's, on the CPU.

The JAX ``JsonlLogger`` writes its events through
``torch.utils.tensorboard``; the port's writes them by hand
(``utils/logging.EventWriter``), importing neither ``tensorboard`` nor
TensorFlow.  Both loggers log the same seeded scalars; both event files,
read back with ``tensorboard``'s ``RawEventFileLoader`` and parsed as
``event_pb2.Event``, give the same ``file_version`` and the same
``(step, tag, simple_value)`` sequence, the values equal in f32, and
every record's two masked CRC-32Cs check by ``tensorboard``'s own CRC.
"""

import glob
import json
import os
import struct

import numpy as np
import pytest
from tensorboard.backend.event_processing.event_file_loader import \
    RawEventFileLoader
from tensorboard.compat.proto import event_pb2
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import \
    masked_crc32c as tb_masked_crc32c

from vl_merging_tpu.train.loop import JsonlLogger as JJsonlLogger
from vl_merging_tpu_torch.train.loop import JsonlLogger
from vl_merging_tpu_torch.utils import logging as tlogging
from torch_port_threads import one_torch_thread  # noqa: F401

# (step, scalars): a zero step, a step past 2^7 and one past 2^32 (both
# varint widths), a negative value, tags with "/" and non-ASCII text
LOGS = [(0, {"train/loss": 2.5, "train/lr": 1e-4}),
        (1, {"train/loss": -0.125}),
        (300, {"val/the_metric": 0.75, "val/tr_r1": 0.0}),
        (2 ** 33 + 5, {"val/ir_r10": 1.0, "train/grad_norm": 3.0e7,
                       "échelle": float(np.float32(0.1))})]


def frames(path):
    """Each record's (length, length CRC, data, data CRC) of a TFRecord
    file."""
    with open(path, "rb") as fh:
        raw = fh.read()
    out, at = [], 0
    while at < len(raw):
        (n,) = struct.unpack_from("<Q", raw, at)
        (len_crc,) = struct.unpack_from("<I", raw, at + 8)
        data = raw[at + 12:at + 12 + n]
        (data_crc,) = struct.unpack_from("<I", raw, at + 12 + n)
        out.append((raw[at:at + 8], len_crc, data, data_crc))
        at += 16 + n
    assert at == len(raw)
    return out


def events(path):
    out = []
    for record in RawEventFileLoader(path).Load():
        ev = event_pb2.Event()
        ev.ParseFromString(record)
        out.append(ev)
    return out


def scalars(evs):
    return [(ev.step, v.tag, v.simple_value)
            for ev in evs if ev.HasField("summary") for v in ev.summary.value]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both loggers over LOGS: (JAX event file, port event file, port
    jsonl path, JAX jsonl path)."""
    root = tmp_path_factory.mktemp("tb")
    jlog = JJsonlLogger(str(root / "jax"), "metrics")
    tlog = JsonlLogger(str(root / "port"), "metrics")
    for step, s in LOGS:
        jlog.log(step, s)
        tlog.log(step, s)
    jlog._tb.close()
    tlog.close()
    found = [glob.glob(str(root / side / "tb" / "metrics" /
                           "events.out.tfevents.*"))
             for side in ("jax", "port")]
    assert [len(f) for f in found] == [1, 1], found
    return (found[0][0], found[1][0], tlog.path, jlog.path)


def test_port_events_read_as_the_jax_events(written):
    jpath, tpath, _, _ = written
    jevs, tevs = events(jpath), events(tpath)
    assert tevs[0].file_version == jevs[0].file_version == "brain.Event:2"
    want = scalars(jevs)
    assert len(want) == sum(len(s) for _, s in LOGS)
    assert scalars(tevs) == want
    assert [ev.step for ev in tevs[1:]] == [ev.step for ev in jevs[1:]]
    assert all(ev.wall_time > 1e9 for ev in tevs)


@pytest.mark.parametrize("side", [0, 1])
def test_every_record_crc_checks(written, side):
    """Both CRCs of every record by tensorboard's masked CRC-32C, the
    port's CRC equal to it, and each data block an ``Event``."""
    path = written[side]
    recs = frames(path)
    assert len(recs) == 1 + sum(len(s) for _, s in LOGS)
    for length, len_crc, data, data_crc in recs:
        assert struct.unpack("<Q", length)[0] == len(data)
        assert len_crc == tb_masked_crc32c(length)
        assert data_crc == tb_masked_crc32c(data)
        assert tlogging.masked_crc32c(data) == data_crc
        event_pb2.Event().ParseFromString(data)


def test_crc32c_check_value():
    """The CRC-32C check value of "123456789" (RFC 3720)."""
    assert tlogging.crc32c(b"123456789") == 0xE3069283
    assert tlogging.crc32c(b"") == 0


def test_jsonl_lines_match_jax(written):
    _, _, tjson, jjson = written
    with open(tjson) as t, open(jjson) as j:
        assert [json.loads(x) for x in t] == [json.loads(x) for x in j]


def test_a_logger_that_does_not_write_makes_no_file(tmp_path):
    log = JsonlLogger(str(tmp_path / "rank1"), "metrics", write=False)
    log.log(1, {"a": 1.0})
    log.close()
    assert not os.path.exists(tmp_path / "rank1")
