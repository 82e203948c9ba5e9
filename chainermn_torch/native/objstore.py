"""ctypes bindings and the object-comm transport for the C++ objstore
sidecar (the port of ``chainermn_tpu/native/objstore.py``, with its own
copy of ``objstore.cc``; the wire protocol is the same, so either
package's client talks to either package's server).

See ``objstore.cc`` for the wire protocol. The library is built at first
use with the system ``g++`` into ``build/`` (``native/_build.py``).
``available()`` never raises — without the sidecar the communicators
keep the gloo object transport
(:func:`~chainermn_torch.communicators._object_comm.create_object_comm`).

Deployment: the store host — normally rank 0's launcher — runs
``serve()`` (or any process makes an ``ObjStoreServer()``), and every
process gets ``CHAINERMN_TORCH_OBJSTORE=host:port`` in its environment
before it creates its communicator.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from chainermn_torch.communicators._object_comm import OBJSTORE_ENV, KVObjectComm

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def _load() -> ctypes.CDLL:
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise RuntimeError(f"objstore library unavailable: {_lib_error}")
    try:
        from chainermn_torch.native._build import build_and_load

        lib = build_and_load("objstore.cc", "objstore")
    except Exception as e:  # missing g++, sandboxed fs, ...
        _lib_error = f"{type(e).__name__}: {e}"
        raise RuntimeError(f"objstore library unavailable: {_lib_error}")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.objstore_server_start.restype = ctypes.c_void_p
    lib.objstore_server_start.argtypes = [ctypes.c_uint16,
                                          ctypes.POINTER(ctypes.c_uint16)]
    lib.objstore_server_stop.argtypes = [ctypes.c_void_p]
    lib.objstore_client_connect.restype = ctypes.c_void_p
    lib.objstore_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
    lib.objstore_client_close.argtypes = [ctypes.c_void_p]
    lib.objstore_put.restype = ctypes.c_int
    lib.objstore_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint32, u8p, ctypes.c_uint64]
    lib.objstore_get.restype = ctypes.c_int
    lib.objstore_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint32, ctypes.c_long,
                                 ctypes.POINTER(u8p),
                                 ctypes.POINTER(ctypes.c_uint64)]
    lib.objstore_del_prefix.restype = ctypes.c_int
    lib.objstore_del_prefix.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint32]
    lib.objstore_dir.restype = ctypes.c_int
    lib.objstore_dir.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint32, ctypes.POINTER(u8p),
                                 ctypes.POINTER(ctypes.c_uint64)]
    lib.objstore_ping.restype = ctypes.c_int
    lib.objstore_ping.argtypes = [ctypes.c_void_p]
    lib.objstore_free.argtypes = [u8p]
    lib.objstore_crc32.restype = ctypes.c_uint32
    lib.objstore_crc32.argtypes = [u8p, ctypes.c_uint64]
    _lib = lib
    return lib


def available() -> bool:
    """True when the sidecar can be used for this launch: the library builds
    (or is cached) AND ``CHAINERMN_TORCH_OBJSTORE`` names the store host."""
    if not os.environ.get(OBJSTORE_ENV):
        return False
    try:
        _load()
        return True
    except Exception:
        return False


class ObjStoreServer:
    """Owns the in-process store + TCP acceptor (normally on process 0)."""

    def __init__(self, port: int = 0) -> None:
        lib = _load()
        out_port = ctypes.c_uint16(0)
        self._h = lib.objstore_server_start(port, ctypes.byref(out_port))
        if not self._h:
            raise RuntimeError(f"objstore server failed to bind port {port}")
        self.port = out_port.value

    def stop(self) -> None:
        if self._h:
            _load().objstore_server_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


# Mirror objstore.cc's frame caps: the server drops a connection mid-stream
# on oversize frames (it cannot resync), so the client must refuse first
# with a diagnosable error.
MAX_KEY_LEN = 1 << 16
MAX_VALUE_LEN = 1 << 31


class ObjStoreClient:
    """One TCP connection to the store (thread-safe; the C side serializes
    roundtrips per connection).

    ``retry`` (a :class:`~chainermn_torch.resilience.retry.RetryPolicy`, or
    None) wraps each put/get roundtrip — a dropped frame or an injected
    ``objstore.put``/``objstore.get`` fault is absorbed before the caller
    sees a failed transfer. The fault cut-points sit INSIDE the retried
    body, so injected transients exercise the retry path exactly like
    real ones."""

    def __init__(self, host: str, port: int, *, retry=None) -> None:
        lib = _load()
        self._lib = lib
        self.retry = retry
        self._h = lib.objstore_client_connect(host.encode(), port)
        if not self._h:
            raise RuntimeError(f"objstore connect failed: {host}:{port}")
        if lib.objstore_ping(self._h) != 0:
            raise RuntimeError(f"objstore ping failed: {host}:{port}")

    def put(self, key: str, value: bytes) -> None:
        kb = key.encode()
        if len(kb) > MAX_KEY_LEN or len(value) > MAX_VALUE_LEN:
            raise ValueError(
                f"objstore frame too large (key {len(kb)}B, value "
                f"{len(value)}B; caps {MAX_KEY_LEN}/{MAX_VALUE_LEN}) — "
                "chunk the payload (NativeObjectComm does this automatically)"
            )
        if self.retry is not None:
            return self.retry.call(self._put_once, kb, value,
                                   op="objstore.put")
        return self._put_once(kb, value)

    def _put_once(self, kb: bytes, value: bytes) -> None:
        from chainermn_torch.resilience.cutpoints import OBJSTORE_PUT
        from chainermn_torch.resilience.faults import inject

        inject(OBJSTORE_PUT, key=kb.decode(), nbytes=len(value))
        buf = (ctypes.c_uint8 * len(value)).from_buffer_copy(value) if value else None
        rc = self._lib.objstore_put(self._h, kb, len(kb), buf, len(value))
        if rc != 0:
            raise RuntimeError(f"objstore put({kb!r}) failed: rc={rc}")

    def get(self, key: str, timeout_ms: int = 600_000) -> bytes:
        kb = key.encode()
        if self.retry is not None:
            return self.retry.call(self._get_once, kb, timeout_ms,
                                   op="objstore.get")
        return self._get_once(kb, timeout_ms)

    def _get_once(self, kb: bytes, timeout_ms: int) -> bytes:
        from chainermn_torch.resilience.cutpoints import OBJSTORE_GET
        from chainermn_torch.resilience.faults import inject

        inject(OBJSTORE_GET, key=kb.decode())
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_uint64(0)
        rc = self._lib.objstore_get(self._h, kb, len(kb), timeout_ms,
                                    ctypes.byref(out), ctypes.byref(n))
        if rc == 1:
            raise TimeoutError(f"objstore get({kb!r}) timed out ({timeout_ms}ms)")
        if rc != 0:
            raise RuntimeError(f"objstore get({kb!r}) failed: rc={rc}")
        try:
            return ctypes.string_at(out, n.value) if n.value else b""
        finally:
            if n.value:
                self._lib.objstore_free(out)

    def delete_prefix(self, prefix: str) -> None:
        kb = prefix.encode()
        self._lib.objstore_del_prefix(self._h, kb, len(kb))

    def list_prefix(self, prefix: str) -> list[str]:
        kb = prefix.encode()
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_uint64(0)
        rc = self._lib.objstore_dir(self._h, kb, len(kb),
                                    ctypes.byref(out), ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(f"objstore dir({prefix!r}) failed: rc={rc}")
        try:
            raw = ctypes.string_at(out, n.value) if n.value else b""
        finally:
            if n.value:
                self._lib.objstore_free(out)
        return [k for k in raw.decode().split("\n") if k]

    def close(self) -> None:
        if self._h:
            self._lib.objstore_client_close(self._h)
            self._h = None


def crc32(data: bytes) -> int:
    """The sidecar's CRC32 (exposed for checkpoint integrity stamps)."""
    lib = _load()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else None
    return int(lib.objstore_crc32(buf, len(data)))


class NativeObjectComm(KVObjectComm):
    """The object-comm interface over the native sidecar.

    The key-value comm's sequencing and ack-GC protocol
    (:class:`~chainermn_torch.communicators._object_comm.KVObjectComm`,
    transport-independent) with the raw-bytes TCP transport: no base64,
    CRC-checked frames. Payloads live under ``<key>/`` (chunked ``c<i>``
    frames + ``hdr``) so the shared GC (which deletes the ``<key>/``
    subtree) covers them. ``rank``/``size`` are the communicator's;
    ``namespace`` is the key prefix all its ranks share
    (:func:`~chainermn_torch.communicators._object_comm.group_namespace`).
    """

    def __init__(self, rank: int, size: int, namespace: str = "0",
                 address: Optional[str] = None) -> None:
        address = address or os.environ[OBJSTORE_ENV]
        host, port = address.rsplit(":", 1)
        self._store = ObjStoreClient(host, int(port))
        self._init_protocol_state(int(rank), int(size), namespace)

    # Payloads above the wire-frame cap are split across numbered keys. The
    # tiny header frame is always written LAST, and readers block only on it
    # — its presence implies every data frame is already in the store.
    _CHUNK = 256 << 20

    def _put(self, key: str, payload: bytes) -> None:
        n = -(-len(payload) // self._CHUNK) if payload else 1
        for i in range(n):
            self._store.put(
                f"{key}/c{i}", payload[i * self._CHUNK : (i + 1) * self._CHUNK]
            )
        self._store.put(key + "/hdr", f"{len(payload)}:{n}".encode())

    def _get(self, key: str, timeout_ms: int = 600_000) -> bytes:
        hdr = self._store.get(key + "/hdr", timeout_ms)
        total, n = (int(v) for v in hdr.decode().split(":"))
        payload = b"".join(
            self._store.get(f"{key}/c{i}", timeout_ms) for i in range(n)
        )
        assert len(payload) == total
        return payload

    def _delete_dir(self, key_prefix: str) -> None:
        try:
            self._store.delete_prefix(key_prefix + "/")
        except Exception:
            pass

    def _ack(self, round_key: str) -> None:
        self._store.put(f"{round_key}/ack/{self.rank}", b"1")

    def _count_acks(self, prefix: str) -> int:
        return len(self._store.list_prefix(prefix))

    def close(self) -> None:
        self._store.close()


def serve(port: int = 0) -> ObjStoreServer:
    """Start a store server and print/export its address (launcher helper)."""
    server = ObjStoreServer(port)
    os.environ.setdefault(OBJSTORE_ENV, f"127.0.0.1:{server.port}")
    return server
