"""Length-prefixed binary wire protocol between the Go shim and the sidecar.

Frame layout (all little-endian):

    magic   u32  = 0x4B545055 ("KTPU")
    version u16
    type    u16  (MsgType)
    req_id  u64  (echoed in the response)
    length  u64  (payload bytes that follow)

Payload = control/data hybrid, Arrow-IPC style:

    header_len u32
    header     JSON (utf-8) — message fields + array manifest
    blobs      raw little-endian array bytes, 64-byte aligned

The JSON header carries the object-shaped control plane (node specs,
pod specs, quota trees — small, schema-evolvable); bulk numerics travel as
raw array blobs described by the manifest ``{"arrays": [{"name", "dtype",
"shape", "offset", "nbytes"}]}``.  This keeps the hot direction — the
[P, N] score matrix back to the Go shim — a single memcpy-able buffer.

The protocol is strictly request/response over one connection; deltas are
batched per message (APPLY) exactly like the informer event batches the
shim accumulates between scheduling cycles.

Restart/resync contract (level-triggered, SURVEY §5.3): the shim replays
from what it authoritatively holds (apiserver CR specs/statuses + its
assign cache), so every irreversible bit travels on the wire and a replay
reconstructs it exactly: gang ``sat`` (OnceResourceSatisfied, from the
plugin's Permit bookkeeping), reservation ``used``/``consumed`` (updated
by the Go PreBind patch), pod ``devalloc`` annotations, and the
reserve-pod assigns for bound reservations.  tests/test_service_resync.py
bit-matches a replayed sidecar against a never-restarted twin across the
full store set.

Durability extension (service.journal): a sidecar started with a state
dir journals every APPLY batch (and assume-SCHEDULE outcome) before it
mutates state and recovers snapshot + journal tail on restart.  Such a
sidecar advertises ``durable: true`` and its recovered ``state_epoch`` in
HELLO, and echoes the post-batch epoch on APPLY/SCHEDULE/DIGEST/HEALTH
replies; the shim then replays only the mirror ops PAST the recovered
epoch (incremental resync) and falls back to the full remove+re-add
replay on any epoch mismatch.  A journal-less sidecar keeps the original
keep-nothing contract unchanged.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

MAGIC = 0x4B545055
VERSION = 1
_HDR = struct.Struct("<IHHQQ")
_ALIGN = 64

# A corrupt or hostile length field must never drive the allocation in
# read_exact: frames past this bound are protocol errors (the score matrix
# for a 100k-node cluster is ~tens of MB; 256 MB is far above any real frame).
MAX_FRAME_LENGTH = 256 << 20

# High bit of the ``type`` u16: the payload carries a CRC32 (IEEE, of the
# payload bytes) as a 4-byte little-endian trailer, counted in ``length``.
# Off by default so existing transcripts stay bit-identical; a client that
# sends it gets it back on the reply (per-frame, stateless).
FLAG_CRC = 0x8000
# Second-highest bit: the payload carries a 64-bit trace id as an 8-byte
# little-endian trailer, counted in ``length`` — wire-level trace
# propagation (the shim stamps one id per LOGICAL operation; the server
# threads it through dispatch/journal/kernel spans and echoes it on the
# reply).  Flagged exactly like FLAG_CRC so the Go golden transcript
# bytes are unchanged when absent, and old peers interoperate: a peer
# that never sets the bit never sees the field.  Trailer order when both
# flags ride one frame: payload, then trace id, then CRC (the CRC covers
# the trace trailer — integrity extends to the id).
FLAG_TRACE = 0x4000
# Third-highest bit: the payload carries a TENANT-ID trailer — the utf-8
# id bytes followed by their u16 length — selecting which of the
# server's isolated per-tenant stores (service.tenants.TenantRegistry)
# the frame addresses.  Flagged exactly like FLAG_CRC/FLAG_TRACE: absent
# means the DEFAULT tenant and the wire bytes (and the Go golden
# transcript) are unchanged.  Trailer order when several ride one frame:
# payload, then tenant, then trace id, then CRC (readers strip CRC
# first, trace second, tenant last — the CRC covers everything).
FLAG_TENANT = 0x2000
# Fourth-highest bit: the payload carries a one-byte QOS-CLASS trailer —
# the request's priority band for the server's admission plane (the
# paper's koord-prod|mid|batch|free co-location bands turned inward onto
# the serving plane).  Flagged exactly like the other trailers: absent
# means "use the tenant's configured default class (else prod)" and the
# wire bytes (and the Go golden transcript) are unchanged.  Trailer
# order when several ride one frame: payload, qos, tenant, trace id,
# CRC (readers strip CRC first, trace second, tenant third, qos last —
# the CRC covers everything).  Replies never echo it: class shapes
# admission, not the response.
FLAG_QOS = 0x1000
_TYPE_MASK = 0x0FFF

# The four priority bands, mirroring the reference PriorityClass tiers
# (koord-prod/koord-mid/koord-batch/koord-free).  The u8 trailer byte is
# the band's rank; LOWER rank == HIGHER priority, and unknown bytes from
# a newer peer degrade to the lowest band rather than erroring.
QOS_CLASSES = ("prod", "mid", "batch", "free")
QOS_RANK = {name: rank for rank, name in enumerate(QOS_CLASSES)}


def qos_name(rank: int) -> str:
    """Band name for a wire rank byte; out-of-range ranks from a newer
    peer degrade to the lowest (best-effort) band."""
    if 0 <= rank < len(QOS_CLASSES):
        return QOS_CLASSES[rank]
    return QOS_CLASSES[-1]


class ErrCode:
    """Structured error taxonomy for ERROR replies.  ``retryable`` in the
    reply fields tells the client whether the same request can be re-sent
    (after reconnect/backoff) or is a semantic failure that will never
    succeed."""

    INTERNAL = "INTERNAL"  # fatal: unexpected server-side failure
    BAD_REQUEST = "BAD_REQUEST"  # fatal: malformed/invalid request
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"  # retryable with a fresh deadline
    UNAVAILABLE = "UNAVAILABLE"  # retryable: draining / shutting down
    # fatal AGAINST THIS NODE: the leader's lease lapsed or a higher term
    # was witnessed — re-sending the same frame here can never succeed;
    # the client must fail over to whichever node holds the new term
    # (service.replication fencing; the error MESSAGE names the terms)
    STALE_TERM = "STALE_TERM"
    # retryable: the admission plane shed this request (queue family full
    # or a brownout rung refused its class) — the server is healthy and
    # serving higher bands; back off (honoring the reply's
    # ``retry_after_ms`` hint) and re-send.  NEVER breaker-counted and
    # never a failover trigger: overload must not look like death.
    OVERLOADED = "OVERLOADED"

RETRYABLE_CODES = frozenset(
    {ErrCode.DEADLINE_EXCEEDED, ErrCode.UNAVAILABLE, ErrCode.OVERLOADED}
)


class MsgType:
    ERROR = 0
    HELLO = 1
    APPLY = 2
    SCORE = 3
    SCHEDULE = 4
    QUOTA_REFRESH = 5
    PING = 6
    NAMES = 7
    ECHO = 8  # diagnostics: arrays round-trip for wire-overhead measurement
    REVOKE = 9  # quota-overuse revoke tick -> pod keys to evict
    DESCHEDULE = 10  # LowNodeLoad balance tick -> migration plan
    METRICS = 11  # Prometheus-style text exposition + watchdog sweep
    RECONCILE = 12  # koord-manager noderesource tick -> batch/mid updates
    HOOK = 13  # runtime-proxy hook rpc (apis/runtime/v1alpha1 service)
    HEALTH = 14  # liveness probe: SERVING/DRAINING + queue depth + latency
    DIGEST = 15  # anti-entropy: per-table state digests (+ per-row on request)
    TRACE = 16  # pull the accumulated Chrome trace_event spans per trace id
    DEBUG = 17  # flight-recorder events since a cursor (structured ring)
    EXPLAIN = 18  # per-pod schedule explanation: score decomposition + reasons
    # hot-standby replication (service.replication): the follower attaches
    # with SUBSCRIBE (tail or snapshot-then-tail), long-polls REPL_ACK for
    # journal records (its epoch is the ack horizon), and is promoted to
    # serving with PROMOTE; REPL_APPLY is the follower's internal
    # single-owner apply path (standby mode only)
    SUBSCRIBE = 19  # follower attach at an epoch -> records | snapshot
    REPL_ACK = 20  # follower ack horizon + long-poll for more records
    PROMOTE = 21  # standby -> serving (failover); idempotent
    REPL_APPLY = 22  # internal: replay shipped records into the standby
    # fleet membership (service.federation): JOIN registers a fresh
    # sidecar with the ACTIVE lease arbiter (admitted under a bumped
    # membership epoch — existing homes never move); STANDBY is the
    # arbiter's re-provisioning command — attach the addressed process
    # as the trailer tenant's standby of the given leader (the wire
    # face of add_tenant_standby).  Both follow the standard trailer
    # rules: FLAG_TENANT/FLAG_TRACE/FLAG_CRC compose unchanged.
    JOIN = 23  # sidecar -> arbiter: admit me into the fleet
    STANDBY = 24  # arbiter -> sidecar: become tenant's standby of leader


_MSG_NAMES = {
    v: k for k, v in vars(MsgType).items() if isinstance(v, int)
}


def msg_name(msg_type: int) -> str:
    return _MSG_NAMES.get(msg_type, f"msg{msg_type}")


def encode_parts(
    msg_type: int, req_id: int, fields: dict, arrays: Optional[Dict[str, np.ndarray]] = None
) -> List:
    """Zero-copy frame as a list of buffers (frame header, json header,
    then array blobs as memoryviews of the caller's arrays)."""
    manifest = []
    blobs: List = []
    off = 0
    if arrays:
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            pad = (-off) % _ALIGN
            if pad:
                blobs.append(b"\x00" * pad)
                off += pad
            nbytes = arr.nbytes
            manifest.append(
                {
                    "name": name,
                    "dtype": arr.dtype.str,
                    "shape": list(arr.shape),
                    "offset": off,
                    "nbytes": nbytes,
                }
            )
            if nbytes:  # zero-size arrays (empty pod batch) have no blob
                blobs.append(memoryview(arr).cast("B"))
            off += nbytes
    header = json.dumps({"fields": fields, "arrays": manifest}).encode()
    length = 4 + len(header) + off
    return [
        _HDR.pack(MAGIC, VERSION, msg_type, req_id, length),
        struct.pack("<I", len(header)),
        header,
    ] + blobs


def encode(msg_type: int, req_id: int, fields: dict, arrays: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    return b"".join(encode_parts(msg_type, req_id, fields, arrays))


def encode_error(
    req_id: int,
    error: str,
    code: str = ErrCode.INTERNAL,
    retryable: Optional[bool] = None,
    trace: str = "",
    retry_after_ms: Optional[int] = None,
) -> bytes:
    """A structured ERROR reply: message + taxonomy code + the retryable
    bit clients key their recovery on.  ``retry_after_ms`` is the
    OVERLOADED shed path's Retry-After hint — how long the client should
    back off before re-offering (advisory; the shim scales it by class)."""
    fields = {
        "error": error,
        "code": code,
        "retryable": code in RETRYABLE_CODES if retryable is None else retryable,
    }
    if trace:
        fields["trace"] = trace
    if retry_after_ms is not None:
        fields["retry_after_ms"] = int(retry_after_ms)
    return encode(MsgType.ERROR, req_id, fields)


def with_crc(data) -> Union[bytes, List]:
    """Wrap an already-encoded frame (bytes or encode_parts list) with the
    CRC32 trailer: sets FLAG_CRC in the type field, extends length by 4,
    appends crc32(payload).  Lets reply paths stay CRC-agnostic — the
    writer applies it per-connection."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = bytes(data)
        magic, version, msg_type, req_id, length = _HDR.unpack_from(buf, 0)
        payload = buf[_HDR.size:]
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        return (
            _HDR.pack(magic, version, msg_type | FLAG_CRC, req_id, length + 4)
            + payload
            + struct.pack("<I", crc)
        )
    parts = list(data)
    magic, version, msg_type, req_id, length = _HDR.unpack(bytes(parts[0]))
    crc = 0
    for part in parts[1:]:
        crc = zlib.crc32(part, crc)
    parts[0] = _HDR.pack(magic, version, msg_type | FLAG_CRC, req_id, length + 4)
    parts.append(struct.pack("<I", crc & 0xFFFFFFFF))
    return parts


def with_trace(data, trace_id: int) -> Union[bytes, List]:
    """Stamp an already-encoded frame (bytes or encode_parts list) with
    the 64-bit trace-id trailer: sets FLAG_TRACE, extends length by 8,
    appends the id little-endian.  Apply BEFORE ``with_crc`` so the CRC
    covers the trace trailer (read order strips CRC first)."""
    tid = struct.pack("<Q", trace_id & 0xFFFFFFFFFFFFFFFF)
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = bytes(data)
        magic, version, msg_type, req_id, length = _HDR.unpack_from(buf, 0)
        return (
            _HDR.pack(magic, version, msg_type | FLAG_TRACE, req_id, length + 8)
            + buf[_HDR.size:]
            + tid
        )
    parts = list(data)
    magic, version, msg_type, req_id, length = _HDR.unpack(bytes(parts[0]))
    parts[0] = _HDR.pack(magic, version, msg_type | FLAG_TRACE, req_id, length + 8)
    parts.append(tid)
    return parts


def with_tenant(data, tenant: str) -> Union[bytes, List]:
    """Stamp an already-encoded frame with the tenant-id trailer — the
    utf-8 bytes followed by their u16 length (length LAST, so a reader
    working backwards from the frame end finds it first): sets
    FLAG_TENANT and extends length.  Apply BEFORE
    ``with_trace``/``with_crc`` so both later trailers (and the CRC's
    coverage) sit after it on the wire."""
    raw = tenant.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise ValueError(f"tenant id too long ({len(raw)} bytes)")
    trailer = raw + struct.pack("<H", len(raw))
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = bytes(data)
        magic, version, msg_type, req_id, length = _HDR.unpack_from(buf, 0)
        return (
            _HDR.pack(
                magic, version, msg_type | FLAG_TENANT, req_id,
                length + len(trailer),
            )
            + buf[_HDR.size:]
            + trailer
        )
    parts = list(data)
    magic, version, msg_type, req_id, length = _HDR.unpack(bytes(parts[0]))
    parts[0] = _HDR.pack(
        magic, version, msg_type | FLAG_TENANT, req_id,
        length + len(trailer),
    )
    parts.append(trailer)
    return parts


def with_qos(data, qos_class: str) -> Union[bytes, List]:
    """Stamp an already-encoded frame with the one-byte qos-class
    trailer (the band's rank): sets FLAG_QOS and extends length by 1.
    Apply BEFORE ``with_tenant``/``with_trace``/``with_crc`` so the qos
    byte sits innermost on the wire (readers strip it last)."""
    try:
        rank = QOS_RANK[qos_class]
    except KeyError:
        raise ValueError(
            f"unknown qos class {qos_class!r} (expected one of {QOS_CLASSES})"
        )
    trailer = struct.pack("<B", rank)
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = bytes(data)
        magic, version, msg_type, req_id, length = _HDR.unpack_from(buf, 0)
        return (
            _HDR.pack(magic, version, msg_type | FLAG_QOS, req_id, length + 1)
            + buf[_HDR.size:]
            + trailer
        )
    parts = list(data)
    magic, version, msg_type, req_id, length = _HDR.unpack(bytes(parts[0]))
    parts[0] = _HDR.pack(
        magic, version, msg_type | FLAG_QOS, req_id, length + 1
    )
    parts.append(trailer)
    return parts


def strip_qos(payload):
    """Strip the one-byte qos trailer off an already-tenant-stripped
    payload; returns ``(payload, class_name)``.  Shared by the two frame
    readers so the parse cannot drift."""
    if len(payload) < 1:
        raise ConnectionError("qos frame shorter than its trailer")
    n = len(payload)
    (rank,) = struct.unpack_from("<B", payload, n - 1)
    return payload[: n - 1], qos_name(rank)


def strip_tenant(payload):
    """Strip the tenant trailer off an already-CRC/trace-stripped
    payload; returns ``(payload, tenant_str)``.  Shared by the two frame
    readers so the parse cannot drift."""
    if len(payload) < 2:
        raise ConnectionError("tenant frame shorter than its trailer")
    n = len(payload)
    (tlen,) = struct.unpack_from("<H", payload, n - 2)
    if n < 2 + tlen:
        raise ConnectionError("tenant trailer longer than its frame")
    tenant = bytes(payload[n - 2 - tlen : n - 2]).decode("utf-8")
    return payload[: n - 2 - tlen], tenant


def decode_header(msg_type_payload: Tuple[int, int, bytes]):
    """Parse ONLY the json header of a frame: ``(msg_type, req_id,
    fields, manifest)`` where ``manifest`` is an opaque handle for
    ``decode_arrays``.  O(header) regardless of blob size — the deadline
    shed path uses this so an overload backlog drains without
    materializing a single stale array."""
    msg_type, req_id, payload = msg_type_payload
    (hlen,) = struct.unpack_from("<I", payload, 0)
    header = json.loads(bytes(payload[4 : 4 + hlen]))
    return msg_type, req_id, header["fields"], (header["arrays"], 4 + hlen, payload)


def decode_arrays(manifest) -> Dict[str, np.ndarray]:
    """Materialize the array views for a ``decode_header`` manifest
    handle (zero-copy ``np.frombuffer`` over the payload)."""
    entries, blob_base, payload = manifest
    arrays = {}
    for m in entries:
        start = blob_base + m["offset"]
        arr = np.frombuffer(
            payload, dtype=np.dtype(m["dtype"]), count=m["nbytes"] // np.dtype(m["dtype"]).itemsize,
            offset=start,
        ).reshape(m["shape"])
        arrays[m["name"]] = arr
    return arrays


def decode(msg_type_payload: Tuple[int, int, bytes]):
    msg_type, req_id, fields, manifest = decode_header(msg_type_payload)
    return msg_type, req_id, fields, decode_arrays(manifest)


def read_exact(sock: socket.socket, n: int) -> memoryview:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return view


def read_frame(
    sock: socket.socket,
    max_length: int = MAX_FRAME_LENGTH,
    return_flags: bool = False,
):
    """(msg_type, req_id, payload[, crc_flag, trace_id, tenant, qos]).
    The declared length is bounded BEFORE any allocation — a corrupt
    length field becomes a ConnectionError, not a giant bytearray.  When
    FLAG_CRC is set the 4-byte trailer is verified and stripped; a
    mismatch is a ConnectionError (the connection's framing can no
    longer be trusted).  When FLAG_TRACE is set the 8-byte trace-id
    trailer is stripped next (CRC covers it — write order appends trace
    first, CRC last), a FLAG_TENANT trailer (u16 len + utf-8) is
    stripped after that, and a FLAG_QOS class byte last (innermost)."""
    hdr = read_exact(sock, _HDR.size)
    magic, version, msg_type, req_id, length = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise ConnectionError(f"bad magic {magic:#x}")
    if version != VERSION:
        raise ConnectionError(f"protocol version {version} != {VERSION}")
    if length > max_length:
        raise ConnectionError(
            f"frame length {length} exceeds max {max_length} "
            f"(corrupt length field or oversized frame)"
        )
    crc_flag = bool(msg_type & FLAG_CRC)
    trace_flag = bool(msg_type & FLAG_TRACE)
    tenant_flag = bool(msg_type & FLAG_TENANT)
    qos_flag = bool(msg_type & FLAG_QOS)
    msg_type &= _TYPE_MASK
    payload = read_exact(sock, length)
    if crc_flag:
        if length < 4:
            raise ConnectionError("CRC frame shorter than its trailer")
        want = struct.unpack_from("<I", payload, length - 4)[0]
        payload = payload[: length - 4]
        got = zlib.crc32(payload) & 0xFFFFFFFF
        if got != want:
            raise ConnectionError(
                f"payload CRC mismatch (got {got:#010x}, want {want:#010x})"
            )
    trace_id = None
    if trace_flag:
        if len(payload) < 8:
            raise ConnectionError("trace frame shorter than its trailer")
        trace_id = struct.unpack_from("<Q", payload, len(payload) - 8)[0]
        payload = payload[: len(payload) - 8]
    tenant = None
    if tenant_flag:
        payload, tenant = strip_tenant(payload)
    qos = None
    if qos_flag:
        payload, qos = strip_qos(payload)
    if return_flags:
        return msg_type, req_id, payload, crc_flag, trace_id, tenant, qos
    return msg_type, req_id, payload


def write_frame(sock: socket.socket, data) -> None:
    """data: one buffer or an encode_parts list.  Small leading parts
    (frame header, json header, pads) are coalesced into one send; only
    multi-MB blobs go out as separate zero-copy sendalls — one small
    syscall + one per big blob instead of a syscall per part."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        sock.sendall(data)
        return
    small = bytearray()
    for part in data:
        if len(part) <= 1 << 16:
            small += part
        else:
            if small:
                sock.sendall(small)
                small = bytearray()
            sock.sendall(part)
    if small:
        sock.sendall(small)


class FrameReader:
    """Buffered zero-copy frame reading for a connection's hot loop.

    ``read_frame``/``read_exact`` cost two-plus ``recv`` syscalls and a
    fresh header allocation per frame; at the serving cadence (APPLY
    bursts of many tiny frames) the syscalls dominate.  FrameReader keeps
    ONE reusable receive buffer per connection, fills it with
    ``recv_into`` (grabbing as many queued frames per syscall as the
    kernel has), and parses headers in place with ``unpack_from`` — a
    burst of small frames costs ~one syscall total, and only the payload
    (which outlives this read: the server queues it to the worker) is
    materialized per frame, filled by a direct ``recv_into`` for the part
    not already buffered.  The wire format is untouched — this is
    representation-internal, and the Go golden transcript reads
    bit-identically.
    """

    def __init__(self, sock: socket.socket,
                 max_length: int = MAX_FRAME_LENGTH, bufsize: int = 1 << 16):
        self._sock = sock
        self._max = max_length
        self._buf = bytearray(max(bufsize, _HDR.size))
        self._start = 0  # parse offset
        self._end = 0  # valid-bytes end

    def _fill(self, need: int) -> None:
        """Ensure ``need`` unparsed bytes (``need`` <= buffer size) are
        buffered, compacting the unparsed tail to the front first."""
        avail = self._end - self._start
        if avail >= need:
            return
        if self._start:
            # bytearray slice assignment handles the overlap
            self._buf[:avail] = self._buf[self._start : self._end]
            self._start, self._end = 0, avail
        view = memoryview(self._buf)
        while self._end - self._start < need:
            r = self._sock.recv_into(view[self._end :])
            if r == 0:
                raise ConnectionError("peer closed")
            self._end += r

    def _take(self, out: memoryview, n: int) -> None:
        """Fill ``out[:n]``: buffered bytes first, then straight
        ``recv_into`` the remainder — the big-payload path never copies
        through the shared buffer."""
        have = min(self._end - self._start, n)
        if have:
            out[:have] = memoryview(self._buf)[self._start : self._start + have]
            self._start += have
        got = have
        while got < n:
            r = self._sock.recv_into(out[got:], n - got)
            if r == 0:
                raise ConnectionError("peer closed")
            got += r

    def read_frame(self, return_flags: bool = False):
        """Same contract (and same validation order) as module-level
        ``read_frame``: bound the declared length BEFORE allocating,
        verify+strip the CRC trailer, then strip the trace trailer."""
        self._fill(_HDR.size)
        magic, version, msg_type, req_id, length = _HDR.unpack_from(
            self._buf, self._start
        )
        self._start += _HDR.size
        if magic != MAGIC:
            raise ConnectionError(f"bad magic {magic:#x}")
        if version != VERSION:
            raise ConnectionError(f"protocol version {version} != {VERSION}")
        if length > self._max:
            raise ConnectionError(
                f"frame length {length} exceeds max {self._max} "
                f"(corrupt length field or oversized frame)"
            )
        crc_flag = bool(msg_type & FLAG_CRC)
        trace_flag = bool(msg_type & FLAG_TRACE)
        tenant_flag = bool(msg_type & FLAG_TENANT)
        qos_flag = bool(msg_type & FLAG_QOS)
        msg_type &= _TYPE_MASK
        raw = bytearray(length)
        payload = memoryview(raw)
        self._take(payload, length)
        if crc_flag:
            if length < 4:
                raise ConnectionError("CRC frame shorter than its trailer")
            want = struct.unpack_from("<I", payload, length - 4)[0]
            payload = payload[: length - 4]
            got = zlib.crc32(payload) & 0xFFFFFFFF
            if got != want:
                raise ConnectionError(
                    f"payload CRC mismatch (got {got:#010x}, want {want:#010x})"
                )
        trace_id = None
        if trace_flag:
            if len(payload) < 8:
                raise ConnectionError("trace frame shorter than its trailer")
            trace_id = struct.unpack_from("<Q", payload, len(payload) - 8)[0]
            payload = payload[: len(payload) - 8]
        tenant = None
        if tenant_flag:
            payload, tenant = strip_tenant(payload)
        qos = None
        if qos_flag:
            payload, qos = strip_qos(payload)
        if return_flags:
            return msg_type, req_id, payload, crc_flag, trace_id, tenant, qos
        return msg_type, req_id, payload


class FrameWriter:
    """Reusable frame-assembly scratch: one ``sendall`` per reply.

    ``write_frame`` allocates a fresh coalescing bytearray per call and
    issues one send per large blob; FrameWriter owns a grow-only scratch
    buffer and assembles the whole ``encode_parts`` list into it when it
    fits (``coalesce_max``), so the steady-state reply costs zero
    allocations and exactly one syscall.  Oversized replies (multi-MB
    score matrices) fall back to the blob-by-blob zero-copy path.  Wire
    bytes are identical to ``write_frame``'s."""

    def __init__(self, sock: socket.socket, coalesce_max: int = 1 << 20):
        self._sock = sock
        self._coalesce_max = coalesce_max
        self._scratch = bytearray()

    def write(self, data) -> None:
        if isinstance(data, (bytes, bytearray, memoryview)):
            self._sock.sendall(data)
            return
        total = 0
        for part in data:
            total += len(part)
        if total <= self._coalesce_max:
            if len(self._scratch) < total:
                self._scratch.extend(bytes(total - len(self._scratch)))
            view = memoryview(self._scratch)
            off = 0
            for part in data:
                n = len(part)
                view[off : off + n] = part
                off += n
            self._sock.sendall(view[:total])
            return
        write_frame(self._sock, data)


# ---------------------------------------------------------------- objects

def pod_to_wire(pod) -> dict:
    d = {"name": pod.name, "ns": pod.namespace, "req": pod.requests, "lim": pod.limits}
    if pod.priority is not None:
        d["prio"] = pod.priority
    if pod.priority_class_label is not None:
        d["cls"] = pod.priority_class_label
    if pod.is_daemonset:
        d["ds"] = True
    if pod.sub_priority:
        d["sub"] = pod.sub_priority
    if pod.create_time:
        d["ct"] = pod.create_time
    if pod.gang:
        d["gang"] = pod.gang
    if pod.quota:
        d["quota"] = pod.quota
    if pod.non_preemptible:
        d["npu"] = True
    if pod.reservations:
        d["rsv"] = pod.reservations
    if pod.qos:
        d["qos"] = pod.qos
    if pod.cpu_bind_policy:
        d["cbp"] = pod.cpu_bind_policy
    if pod.cpu_exclusive_policy:
        d["cep"] = pod.cpu_exclusive_policy
    if pod.device_allocation:
        d["devalloc"] = pod.device_allocation
    ev = {}
    if pod.owner_uid:
        ev["ouid"] = pod.owner_uid
    if pod.owner_kind:
        ev["okind"] = pod.owner_kind
    if pod.deletion_cost:
        ev["dcost"] = pod.deletion_cost
    if pod.eviction_cost:
        ev["ecost"] = pod.eviction_cost
    if pod.is_mirror:
        ev["mirror"] = True
    if pod.is_terminating:
        ev["term"] = True
    if pod.is_failed:
        ev["failed"] = True
    if not pod.is_ready:
        ev["notready"] = True
    if pod.has_local_storage:
        ev["localvol"] = True
    if pod.has_pvc:
        ev["pvc"] = True
    if pod.labels:
        ev["labels"] = pod.labels
    if pod.evict_annotation:
        ev["evictann"] = True
    # upstream-descheduler plugin surface (service/deschedplugins.py)
    if pod.phase != "Running":
        ev["phase"] = pod.phase
    if pod.status_reasons:
        ev["reasons"] = pod.status_reasons
    if pod.init_status_reasons:
        ev["init_reasons"] = pod.init_status_reasons
    if pod.restart_count:
        ev["restarts"] = pod.restart_count
    if pod.init_restart_count:
        ev["init_restarts"] = pod.init_restart_count
    if pod.container_images:
        ev["images"] = pod.container_images
    if pod.topology_spread:
        ev["topo"] = pod.topology_spread
    if ev:
        d["evict"] = ev
    if pod.node_selector is not None:
        d["nodesel"] = pod.node_selector
    if pod.tolerations:
        d["tol"] = pod.tolerations
    if pod.anti_affinity is not None:
        d["antiaff"] = pod.anti_affinity
    return d


def pod_from_wire(d: dict):
    from koordinator_tpu_torch.api.model import Pod, normalize_resources

    ev = d.get("evict", {})
    return Pod(
        name=d["name"],
        namespace=d.get("ns", "default"),
        requests=normalize_resources({k: int(v) for k, v in d.get("req", {}).items()}),
        limits=normalize_resources({k: int(v) for k, v in d.get("lim", {}).items()}),
        priority=d.get("prio"),
        priority_class_label=d.get("cls"),
        is_daemonset=d.get("ds", False),
        sub_priority=d.get("sub", 0),
        create_time=d.get("ct", 0.0),
        gang=d.get("gang"),
        quota=d.get("quota"),
        non_preemptible=d.get("npu", False),
        reservations=list(d.get("rsv", [])),
        qos=d.get("qos"),
        cpu_bind_policy=d.get("cbp"),
        cpu_exclusive_policy=d.get("cep"),
        device_allocation=d.get("devalloc"),
        owner_uid=ev.get("ouid"),
        owner_kind=ev.get("okind"),
        deletion_cost=ev.get("dcost", 0),
        eviction_cost=ev.get("ecost", 0),
        is_mirror=ev.get("mirror", False),
        is_terminating=ev.get("term", False),
        is_failed=ev.get("failed", False),
        is_ready=not ev.get("notready", False),
        has_local_storage=ev.get("localvol", False),
        has_pvc=ev.get("pvc", False),
        labels=dict(ev.get("labels", {})),
        evict_annotation=ev.get("evictann", False),
        node_selector=d.get("nodesel"),
        tolerations=list(d.get("tol", [])),
        anti_affinity=d.get("antiaff"),
        phase=ev.get("phase", "Running"),
        status_reasons=list(ev.get("reasons", [])),
        init_status_reasons=list(ev.get("init_reasons", [])),
        restart_count=ev.get("restarts", 0),
        init_restart_count=ev.get("init_restarts", 0),
        container_images=list(ev.get("images", [])),
        topology_spread=list(ev.get("topo", [])),
    )


def spec_only(node):
    """The Node *spec* the informer's node event carries — no metric, no
    assign cache (those travel on their own delta streams)."""
    from koordinator_tpu_torch.api.model import Node

    return Node(
        name=node.name,
        allocatable=dict(node.allocatable),
        labels=dict(node.labels),
        taints=list(node.taints),
        unschedulable=node.unschedulable,
        raw_allocatable=dict(node.raw_allocatable) if node.raw_allocatable else None,
        amplification_ratios=(
            dict(node.amplification_ratios) if node.amplification_ratios else None
        ),
        node_reservation=(
            dict(node.node_reservation) if node.node_reservation else None
        ),
        custom_usage_thresholds=node.custom_usage_thresholds,
        custom_prod_usage_thresholds=node.custom_prod_usage_thresholds,
        custom_agg_usage_thresholds=node.custom_agg_usage_thresholds,
        custom_agg_type=node.custom_agg_type,
        custom_agg_duration=node.custom_agg_duration,
        has_custom_annotation=node.has_custom_annotation,
    )


def node_spec_to_wire(node) -> dict:
    d = {"name": node.name, "alloc": node.allocatable}
    if node.labels:
        d["labels"] = node.labels
    if node.taints:
        d["taints"] = node.taints
    if node.unschedulable:
        d["unsched"] = True
    if node.raw_allocatable:
        d["raw_alloc"] = node.raw_allocatable
    if node.amplification_ratios:
        d["amp"] = node.amplification_ratios
    if node.node_reservation:
        d["nresv"] = node.node_reservation
    if node.has_custom_annotation:
        d["custom"] = {
            "usage": node.custom_usage_thresholds,
            "prod": node.custom_prod_usage_thresholds,
            "agg_usage": node.custom_agg_usage_thresholds,
            "agg_type": node.custom_agg_type.value if node.custom_agg_type else None,
            "agg_dur": node.custom_agg_duration,
        }
    return d


def node_spec_from_wire(d: dict):
    from koordinator_tpu_torch.api.model import AggregationType, Node, normalize_resources

    node = Node(
        name=d["name"],
        allocatable=normalize_resources(
            {k: int(v) for k, v in d.get("alloc", {}).items()}
        ),
        labels=dict(d.get("labels", {})),
        taints=list(d.get("taints", [])),
        unschedulable=d.get("unsched", False),
        raw_allocatable=(
            {k: int(v) for k, v in d["raw_alloc"].items()} if d.get("raw_alloc") else None
        ),
        amplification_ratios=(
            {k: float(v) for k, v in d["amp"].items()} if d.get("amp") else None
        ),
        node_reservation=d.get("nresv"),
    )
    c = d.get("custom")
    if c:
        node.has_custom_annotation = True
        node.custom_usage_thresholds = c.get("usage")
        node.custom_prod_usage_thresholds = c.get("prod")
        node.custom_agg_usage_thresholds = c.get("agg_usage")
        node.custom_agg_type = AggregationType(c["agg_type"]) if c.get("agg_type") else None
        node.custom_agg_duration = c.get("agg_dur")
    return node


def metric_to_wire(metric) -> dict:
    d = {
        "usage": metric.node_usage,
        "t": metric.update_time,
        "interval": metric.report_interval,
    }
    if metric.pods_usage:
        d["pods"] = metric.pods_usage
        d["prod"] = {k: True for k, v in metric.prod_pods.items() if v}
    if metric.aggregated:
        d["agg"] = {
            str(dur): {t.value: u for t, u in by_type.items()}
            for dur, by_type in metric.aggregated.items()
        }
    return d


def metric_from_wire(d: dict):
    from koordinator_tpu_torch.api.model import AggregationType, NodeMetric

    m = NodeMetric(
        node_usage=(
            {k: int(v) for k, v in d["usage"].items()} if d.get("usage") is not None else None
        ),
        update_time=d.get("t"),
        report_interval=d.get("interval", 60.0),
    )
    for key, usage in d.get("pods", {}).items():
        m.pods_usage[key] = {k: int(v) for k, v in usage.items()}
    for key in d.get("prod", {}):
        m.prod_pods[key] = True
    for dur, by_type in d.get("agg", {}).items():
        m.aggregated[float(dur)] = {
            AggregationType(t): {k: int(v) for k, v in u.items()}
            for t, u in by_type.items()
        }
    return m


def gang_to_wire(info) -> dict:
    d = {
        "name": info.name,
        "min": info.min_member,
        "total": info.total_children,
        "mode": info.mode,
        "policy": info.match_policy,
        "group": list(info.gang_group),
        "ct": info.create_time,
    }
    if info.once_satisfied:
        # the persisted irreversible OnceResourceSatisfied bit (gang.go:455-463)
        # must survive a sidecar restart/resync
        d["sat"] = True
    return d


def gang_from_wire(d: dict):
    from koordinator_tpu_torch.service.constraints import (
        GANG_MODE_STRICT,
        MATCH_ONCE_SATISFIED,
        GangInfo,
    )

    return GangInfo(
        name=d["name"],
        min_member=int(d["min"]),
        total_children=int(d.get("total", 0)),
        mode=d.get("mode", GANG_MODE_STRICT),
        match_policy=d.get("policy", MATCH_ONCE_SATISFIED),
        gang_group=tuple(d.get("group", ())),
        create_time=d.get("ct", 0.0),
        once_satisfied=d.get("sat", False),
    )


def reservation_to_wire(info) -> dict:
    d = {
        "name": info.name,
        "node": info.node,
        "alloc": info.allocatable,
        "used": info.allocated,
    }
    if info.order:
        d["order"] = info.order
    if info.allocate_once:
        d["once"] = True
    if info.consumed_once:
        # AllocateOnce already claimed — must survive a restart/resync or the
        # reservation re-enters the available set and double-allocates
        d["consumed"] = True
    if info.priority:
        d["prio"] = info.priority
    if info.create_time:
        d["ct"] = info.create_time
    if info.unschedulable_count:
        # error-handler status survives a restart/resync like every other
        # server-side reservation bit
        d["unsched"] = info.unschedulable_count
        d["err"] = info.last_error
    if info.ttl is not None:
        # spec.ttl (TTLSecondsAfterCreation): migration-created
        # reservations carry an expiry the recovery twin must honor —
        # without it a replayed reservation would never expire and the
        # abort arms would diverge from an undisturbed run
        d["ttl"] = info.ttl
    return d


def reservation_from_wire(d: dict):
    from koordinator_tpu_torch.api.model import normalize_resources
    from koordinator_tpu_torch.service.constraints import ReservationInfo

    return ReservationInfo(
        name=d["name"],
        node=d.get("node"),  # None = pending, the cycle will place it
        allocatable=normalize_resources(
            {k: int(v) for k, v in d.get("alloc", {}).items()}
        ),
        allocated=normalize_resources(
            {k: int(v) for k, v in d.get("used", {}).items()}
        ),
        order=int(d.get("order", 0)),
        allocate_once=d.get("once", False),
        consumed_once=d.get("consumed", False),
        priority=int(d.get("prio", 0)),
        create_time=d.get("ct", 0.0),
        unschedulable_count=int(d.get("unsched", 0)),
        last_error=d.get("err", ""),
        ttl=float(d["ttl"]) if d.get("ttl") is not None else None,
    )


def topology_to_wire(info) -> dict:
    d = {
        "sockets": info.topo.sockets,
        "nps": info.topo.nodes_per_socket,
        "cpn": info.topo.cores_per_node,
        "cpc": info.topo.cpus_per_core,
        "policy": info.policy,
        "ratio": info.cpu_ratio,
    }
    if info.max_ref_count != 1:
        d["maxref"] = info.max_ref_count
    return d


def topology_from_wire(d: dict):
    from koordinator_tpu_torch.core.numa import CPUTopology
    from koordinator_tpu_torch.service.state import NodeTopologyInfo

    return NodeTopologyInfo(
        topo=CPUTopology(
            sockets=int(d["sockets"]),
            nodes_per_socket=int(d["nps"]),
            cores_per_node=int(d["cpn"]),
            cpus_per_core=int(d["cpc"]),
        ),
        policy=d.get("policy", "none"),
        cpu_ratio=float(d.get("ratio", 1.0)),
        max_ref_count=int(d.get("maxref", 1)),
    )


def devices_to_wire(gpus, rdma=()) -> dict:
    return {
        "gpus": [
            {"minor": g.minor, "numa": g.numa_node, "pcie": g.pcie}
            for g in gpus
        ],
        "rdma": [
            {"minor": r.minor, "vfs": r.vfs_free, "numa": r.numa_node, "pcie": r.pcie}
            for r in rdma
        ],
    }


def devices_from_wire(d: dict):
    from koordinator_tpu_torch.core.deviceshare import GPUDevice, RDMADevice

    gpus = [
        GPUDevice(
            minor=int(g["minor"]),
            numa_node=int(g.get("numa", 0)),
            pcie=int(g.get("pcie", 0)),
        )
        for g in d.get("gpus", [])
    ]
    rdma = [
        RDMADevice(
            minor=int(r["minor"]),
            vfs_free=int(r.get("vfs", 1)),
            numa_node=int(r.get("numa", 0)),
            pcie=int(r.get("pcie", 0)),
        )
        for r in d.get("rdma", [])
    ]
    return gpus, rdma


def quota_group_to_wire(g) -> dict:
    return {
        "name": g.name,
        "parent": g.parent,
        "min": g.min,
        "max": g.max,
        "weight": g.shared_weight,  # null = defaults to max (quota_info.go)
        "guarantee": g.guarantee,
        "req": g.pod_requests,
        "used": g.used,
        "npu": g.non_preemptible_used,
        "lent": g.allow_lent,
        "scale": g.enable_scale_min,
        "is_parent": g.is_parent,
    }


def quota_group_from_wire(d: dict):
    from koordinator_tpu_torch.api.model import normalize_resources
    from koordinator_tpu_torch.api.quota import QuotaGroup

    def rl(key):
        # TransformElasticQuotaWithDeprecatedBatchResources
        # (elastic_quota_transformer.go:43): deprecated names normalize
        # at ingestion, like the informer-level transformer
        return normalize_resources({k: int(v) for k, v in d.get(key, {}).items()})

    return QuotaGroup(
        name=d["name"],
        parent=d["parent"],
        min=rl("min"),
        max=rl("max"),
        shared_weight=rl("weight") if d.get("weight") is not None else None,
        guarantee=rl("guarantee"),
        pod_requests=rl("req"),
        used=rl("used"),
        non_preemptible_used=rl("npu"),
        allow_lent=d.get("lent", True),
        enable_scale_min=d.get("scale", False),
        is_parent=d.get("is_parent", False),
    )
