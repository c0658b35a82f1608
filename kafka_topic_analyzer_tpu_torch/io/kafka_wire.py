"""Kafka wire-protocol record source (librdkafka replacement; port of the
reference's ``io/kafka_wire.py``).

The port leaves out, for now: the fleet's all-topics discovery, the
follow mode's watermark refresh and healing, and the snapshot hooks
(resume validation, seeded spans, the checkpointed partition facts).  The
fused sink's fallbacks are counted on the sink by reason
(`packing.FusedPackSink.fallbacks`, booked on ``kta_fused_fallback_total``)
and logged.

Speaks the Kafka protocol directly over TCP (codec in kafka_codec.py) and
reproduces the reference consumer's observable behavior (src/kafka.rs):

- topology handshake: Metadata + per-partition earliest/latest watermarks
  fixed at scan start (src/kafka.rs:60-72); missing topic raises, like the
  reference's ``panic!("Topic not found!")``;
- full earliest→latest read per partition; termination when every partition
  reaches its snapshot-time high watermark (src/kafka.rs:119-121);
- no consumer group protocol at all: the reference already runs with
  ``enable.auto.commit=false`` + a fresh UUID group id per run
  (src/kafka.rs:28-34), i.e. group membership never has an observable
  effect — so this client fetches directly from partition leaders;
- ``--librdkafka`` overrides map onto this client's knobs: fetch tuning
  (fetch.wait.max.ms, fetch.min.bytes, fetch.max.bytes,
  max.partition.fetch.bytes, fetch.error.backoff.ms, check.crcs,
  receive.message.max.bytes), socket tuning (socket.timeout.ms,
  socket.connection.setup.timeout.ms, broker.address.family,
  socket.keepalive.enable, socket.nagle.disable,
  socket.send/receive.buffer.bytes), transport-fault recovery
  (retry.backoff.ms, reconnect.backoff.ms, reconnect.backoff.max.ms, and
  the non-librdkafka transport.retry.budget — see config.py
  ``TransportRetryConfig`` and io/retry.py), TLS and SASL properties.
  A partition that stays unreachable past its retry budget is marked
  *degraded* (``self.degraded``) and dropped from the scan instead of
  aborting it; the engine/CLI report it and exit non-zero.  Properties
  that are valid librdkafka consumer config but can have no effect here
  (KNOWN_NOOP_PROPERTIES — group/commit settings the reference disables
  anyway) are accepted silently; truly unknown keys warn, like librdkafka
  logs unknown properties.
- corrupt-data resilience (``--on-corruption``/``--quarantine-dir``, or
  the ``on.corruption``/``quarantine.dir`` overrides): a frame that fails
  decode is re-fetched once to rule out an in-flight bit flip; a second
  byte-identical failure is deterministic on-disk corruption, and policy
  applies — ``fail`` aborts with the classified `CorruptFrameError`
  (default), ``skip``/``quarantine`` skip exactly the poisoned frame
  (salvaging the rest of the response via
  kafka_codec.salvage_batch_frames), account for it per partition
  (``corruption_stats``), and optionally spool the raw bytes + JSON
  sidecar (io/quarantine.py).  ``check.crcs`` (or ``--check-crcs``)
  upgrades detection from structural damage to full payload checksums.

Record metadata is extracted batch-at-a-time: key/value lengths, null flags,
second-granularity timestamps (truncated toward zero like Rust's ``/ 1000``,
src/metric.rs:209-211), and key hashes via the native C++ shim when
available (numpy fallback otherwise).  Payload bytes never leave this module
(SURVEY.md §7 hard part (b)).
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import struct
import threading
from time import perf_counter as _perf_counter
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from kafka_topic_analyzer_tpu_torch.config import (
    CorruptionConfig,
    DataLossConfig,
    TransportRetryConfig,
)
from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.retry import (
    Backoff,
    PartitionRetryBudget,
    note_backoff_sleep,
)
from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.obs import events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace
from kafka_topic_analyzer_tpu_torch.ops.fnv import fnv1a32_ref_batch, fnv1a64_batch
from kafka_topic_analyzer_tpu_torch.records import RecordBatch

log = logging.getLogger(__name__)

CLIENT_ID = "topic-analyzer"  # src/kafka.rs:36

#: Ceiling for the auto-grown per-partition fetch size (librdkafka caps
#: message.max.bytes at ~1 GB; also keeps the i32 wire field safe).
MAX_PARTITION_FETCH_BYTES = 1 << 30

#: Disambiguation re-fetches a corrupt span survives at one anchor before
#: the verdict is forced even when the classification KIND keeps changing
#: (a link that mutates every response differently must not re-fetch
#: forever; a matching kind — the deterministic-on-disk case — settles
#: after a single re-fetch regardless).
_MAX_SUSPECT_ROUNDS = 4

#: librdkafka property names that are VALID for the reference's consumer
#: (src/kafka.rs:24-44 sets several of them) but have no observable effect
#: in this client by design: no consumer group is ever formed (the
#: reference never commits), there is no producer, and log tuning is
#: handled by Python logging.  Accepted silently (debug log) rather than
#: warned about, so reference-style invocations stay quiet.
KNOWN_NOOP_PROPERTIES = frozenset({
    "group.id", "session.timeout.ms", "heartbeat.interval.ms",
    "max.poll.interval.ms", "enable.auto.commit", "auto.commit.interval.ms",
    "auto.offset.reset", "enable.partition.eof", "enable.auto.offset.store",
    "queue.buffering.max.ms", "queued.min.messages",
    "queued.max.messages.kbytes", "client.id", "statistics.interval.ms",
    "api.version.request", "broker.version.fallback", "debug", "log_level",
    "allow.auto.create.topics", "client.rack", "metadata.max.age.ms",
    "topic.metadata.refresh.interval.ms",
})


@dataclasses.dataclass
class SocketOptions:
    """Socket-level knobs mapped from librdkafka property names."""

    connect_timeout_s: float = 30.0
    #: 0 = any family; socket.AF_INET / AF_INET6 to pin (broker.address.family)
    family: int = 0
    keepalive: bool = False      # socket.keepalive.enable
    nodelay: bool = True         # socket.nagle.disable (our default: on)
    sndbuf: int = 0              # socket.send.buffer.bytes (0 = OS default)
    rcvbuf: int = 0              # socket.receive.buffer.bytes


def _hash_keys(
    keys: List[Optional[bytes]], use_native: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """fnv32-variant + fnv64 hashes for a list of key byte strings."""
    n = len(keys)
    data = b"".join(k or b"" for k in keys)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(k) if k else 0 for k in keys], out=offsets[1:])
    # native_available caches build failures, so a broken toolchain costs
    # one probe, not one build per batch.
    if use_native and native.native_available():
        return native.hash_batch_native(data, offsets)
    maxlen = int((offsets[1:] - offsets[:-1]).max(initial=0))
    padded = np.zeros((n, max(maxlen, 1)), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    lengths = offsets[1:] - offsets[:-1]
    for i in range(n):
        if lengths[i]:
            padded[i, : lengths[i]] = buf[offsets[i] : offsets[i + 1]]
    return fnv1a32_ref_batch(padded, lengths), fnv1a64_batch(padded, lengths)


class BrokerConnection:
    """One blocking TCP (optionally TLS) connection to a broker.

    `request` is serialized by a lock: sharded scans prefetch per-shard
    batch streams from worker threads (utils/prefetch.py) that share the
    per-broker connections.
    """

    def __init__(
        self,
        host: str,
        port: int,
        timeout_s: float = 10.0,
        ssl_context=None,
        sasl: "Optional[Tuple[str, str, str]]" = None,
        sock_opts: Optional[SocketOptions] = None,
    ):
        """``sasl`` is (mechanism, username, password); mechanism one of
        PLAIN, SCRAM-SHA-256, SCRAM-SHA-512."""
        self.host = host
        self.port = port
        opts = sock_opts or SocketOptions()
        if opts.family:
            # Pinned address family (broker.address.family=v4/v6):
            # create_connection can't filter, so resolve explicitly.
            infos = socket.getaddrinfo(
                host, port, opts.family, socket.SOCK_STREAM
            )
            if not infos:
                raise OSError(f"no address of requested family for {host}")
            af, kind, proto, _cn, addr = infos[0]
            sock = socket.socket(af, kind, proto)
            sock.settimeout(opts.connect_timeout_s)
            try:
                sock.connect(addr)
            except BaseException:
                sock.close()
                raise
        else:
            sock = socket.create_connection(
                (host, port), timeout=opts.connect_timeout_s
            )
        sock.settimeout(timeout_s)
        if opts.nodelay:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if opts.keepalive:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        if opts.sndbuf:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, opts.sndbuf)
        if opts.rcvbuf:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, opts.rcvbuf)
        if ssl_context is not None:
            sock = ssl_context.wrap_socket(sock, server_hostname=host)
        self.sock = sock
        self._corr = 0
        self._inflight: "Dict[int, Tuple[int, int]]" = {}
        self._lock = threading.Lock()
        #: ApiVersions handshake result, filled lazily ({} = legacy broker).
        self.api_versions: "Optional[Dict[int, tuple[int, int]]]" = None
        if sasl is not None:
            try:
                self._authenticate(*sasl)
            except BaseException:
                self.close()  # don't leak the fd on failed auth
                raise

    def _sasl_handshake(self, mechanism: str) -> None:
        r = self.request(
            kc.API_SASL_HANDSHAKE, 1, kc.encode_sasl_handshake_request(mechanism)
        )
        err, mechanisms = kc.decode_sasl_handshake_response(r)
        if err:
            raise kc.KafkaProtocolError(
                f"SASL handshake failed (error {err}); broker offers "
                f"mechanisms {mechanisms} — this client asked for {mechanism}"
            )

    def _sasl_round(self, auth_bytes: bytes) -> bytes:
        """One SaslAuthenticate round trip → server auth bytes."""
        r = self.request(
            kc.API_SASL_AUTHENTICATE,
            0,
            kc.encode_sasl_authenticate_request(auth_bytes),
        )
        err, msg, server_bytes = kc.decode_sasl_authenticate_response(r)
        if err:
            raise kc.KafkaProtocolError(
                f"SASL authentication failed (error {err}): {msg or 'no detail'}"
            )
        return server_bytes

    def _authenticate(self, mechanism: str, username: str, password: str) -> None:
        """SaslHandshake v1 + SaslAuthenticate v0 exchange(s) — must be the
        first traffic on the connection (brokers reject anything else
        before authentication).  PLAIN is one round; SCRAM is two (RFC
        5802 client-first/client-final), with the server's signature
        verified so a spoofed broker can't fake success."""
        self._sasl_handshake(mechanism)
        if mechanism == "PLAIN":
            self._sasl_round(kc.sasl_plain_token(username, password))
            return
        scram = kc.ScramClient(mechanism, username, password)
        server_first = self._sasl_round(scram.first_message())
        server_final = self._sasl_round(scram.final_message(server_first))
        scram.verify_server_final(server_final)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _recv_exact(self, n: int) -> "memoryview":
        # recv_into one preallocated buffer: fetch responses run to tens
        # of MB, so chunk-list assembly (or a final bytes() copy) would
        # duplicate every byte.  numpy's allocator skips the zero-fill a
        # bytearray(n) would pay (a full extra memset pass at 64 MB).
        # ByteReader and the frame decoders slice/unpack memoryviews;
        # string fields go through bytes() at the decode site.
        import numpy as _np

        buf = _np.empty(n, dtype=_np.uint8)
        view = memoryview(buf).cast("B")
        got = 0
        while got < n:
            r = self.sock.recv_into(view[got:])
            if r == 0:
                raise kc.KafkaProtocolError(
                    f"broker {self.host}:{self.port} closed the connection"
                )
            got += r
        return view

    def send_request(self, api_key: int, api_version: int, body: bytes) -> int:
        """Pipelining half 1: send only, return the correlation id.

        Kafka responds strictly in request order per connection, so a
        caller that owns the connection may send the next fetch before
        reading the previous response (the wire client's send-ahead).
        Callers sharing a connection must use `request` instead — split
        halves from two threads would race for each other's bytes."""
        with self._lock:
            self._corr += 1
            corr = self._corr
            # Response-header shape depends on the REQUEST's api version
            # (flexible responses carry a tag buffer after the correlation
            # id); remember it so read_response can strip it even when
            # requests are pipelined.
            self._inflight[corr] = (api_key, api_version)
            self.sock.sendall(
                kc.encode_request(api_key, api_version, corr, CLIENT_ID, body)
            )
            return corr

    @staticmethod
    def _strip_header_tags(r: kc.ByteReader, api_key: int, api_version: int) -> None:
        # ApiVersions responses keep header v0 forever (the broker answers
        # before knowing the client's flexible support).
        if api_key != kc.API_VERSIONS and kc.is_flexible(api_key, api_version):
            r.skip_tags()

    def read_response(self, corr: int) -> kc.ByteReader:
        """Pipelining half 2: read the next response; must match ``corr``."""
        with self._lock:
            (length,) = struct.unpack(">i", self._recv_exact(4))
            payload = self._recv_exact(length)
            meta = self._inflight.pop(corr, None)
        r = kc.ByteReader(payload)
        got_corr = r.i32()
        if got_corr != corr:
            raise kc.KafkaProtocolError(
                f"correlation id mismatch: sent {corr}, got {got_corr}"
            )
        if meta is not None:
            self._strip_header_tags(r, *meta)
        return r

    def request(self, api_key: int, api_version: int, body: bytes) -> kc.ByteReader:
        with self._lock:
            self._corr += 1
            corr = self._corr
            self.sock.sendall(
                kc.encode_request(api_key, api_version, corr, CLIENT_ID, body)
            )
            (length,) = struct.unpack(">i", self._recv_exact(4))
            payload = self._recv_exact(length)
        r = kc.ByteReader(payload)
        got_corr = r.i32()
        if got_corr != corr:
            raise kc.KafkaProtocolError(
                f"correlation id mismatch: sent {corr}, got {got_corr}"
            )
        self._strip_header_tags(r, api_key, api_version)
        return r


def parse_bootstrap(bootstrap_servers: str) -> List[Tuple[str, int]]:
    """Comma-separated host[:port] list (src/main.rs:45-51).

    IPv6: ``[2001:db8::1]:9092`` (bracketed, RFC 3986 style) and bare
    ``::1`` (multiple colons ⇒ whole string is the host, default port)."""
    out = []
    for hp in bootstrap_servers.split(","):
        hp = hp.strip()
        if not hp:
            continue
        if hp.startswith("["):  # bracketed IPv6, optional :port
            host, _, rest = hp[1:].partition("]")
            port = rest[1:] if rest.startswith(":") else ""
        elif hp.count(":") > 1:  # bare IPv6 literal, no port
            host, port = hp, ""
        else:
            host, _, port = hp.rpartition(":") if ":" in hp else (hp, "", "")
        out.append((host or hp, int(port) if port else 9092))
    return out


class DataLossError(kc.KafkaProtocolError):
    """The log mutated out from under the scan (retention race, truncation
    after an unclean election, resume below log-start) and the data-loss
    policy is ``fail``.  The loss is booked (its lost span) before this
    raises; the CLI maps it to ``EXIT_DATA_LOSS`` instead of the generic
    protocol-error exit (the port writes no checkpoint)."""

    def __init__(self, message: str, span: dict):
        super().__init__(message)
        #: The lost-span record ({partition, start, end, records, reason})
        #: that tripped the policy.
        self.span = span


class _TransportFailure:
    """Phase-1 fetch result when a leader's transport died mid-round: the
    serial phase books the failure against the leader's partitions instead
    of letting the exception abort the scan."""

    __slots__ = ("leader", "partitions", "error")

    def __init__(self, leader: int, partitions: List[int], error: BaseException):
        self.leader = leader
        self.partitions = partitions
        self.error = error


class KafkaWireSource(RecordSource):
    def __init__(
        self,
        bootstrap_servers: str,
        topic: str,
        overrides: Optional[Dict[str, str]] = None,
        timeout_s: float = 10.0,
        use_native_hashing: bool = True,
        corruption: Optional[CorruptionConfig] = None,
        data_loss: Optional[DataLossConfig] = None,
    ):
        self.topic = topic
        self.use_native_hashing = use_native_hashing
        overrides = dict(overrides or {})
        #: Poison-frame policy (--on-corruption / --quarantine-dir; also
        #: reachable as on.corruption / quarantine.dir overrides).  On-disk
        #: corruption is deterministic — every re-fetch returns the same
        #: bytes — so after ONE disambiguating re-fetch reproduces the
        #: failure, the policy applies: fail aborts (the default, today's
        #: behavior), skip/quarantine resume at the next batch boundary.
        policy_override = overrides.pop("on.corruption", "fail")
        qdir_override = overrides.pop("quarantine.dir", None)
        if corruption is not None:
            # Explicit config wins; the override keys are still popped so
            # they don't trip the unknown-property warning, but their
            # values (and their validation) are discarded.
            if policy_override != "fail" or qdir_override:
                log.warning(
                    "on.corruption/quarantine.dir overrides ignored: an "
                    "explicit corruption config (--on-corruption/"
                    "--quarantine-dir) takes precedence"
                )
            self.corruption = corruption
        else:
            self.corruption = CorruptionConfig(
                policy=policy_override, quarantine_dir=qdir_override
            )
        self._quarantine = None
        if self.corruption.policy == "quarantine":
            from kafka_topic_analyzer_tpu_torch.io.quarantine import QuarantineStore

            self._quarantine = QuarantineStore(self.corruption.quarantine_dir)
        #: Log-mutation policy (--on-data-loss; also reachable as the
        #: on.data.loss override).  Unlike corruption, loss is ALWAYS
        #: booked — the policy only decides whether the scan keeps going.
        loss_override = overrides.pop("on.data.loss", "report")
        if data_loss is not None:
            if loss_override != "report":
                log.warning(
                    "on.data.loss override ignored: an explicit data-loss "
                    "config (--on-data-loss) takes precedence"
                )
            self.data_loss = data_loss
        else:
            self.data_loss = DataLossConfig(policy=loss_override)
        #: (partition, anchor) -> span record, for every poisoned span this
        #: scan skipped (or, seeded from a snapshot, a previous run
        #: skipped).  Guarded by _corrupt_lock: sharded scans run several
        #: batches() streams against one source.
        self._corrupt_spans: "Dict[Tuple[int, int], dict]" = {}
        #: partition -> (anchor, kind, rounds) of the span awaiting its
        #: disambiguating re-fetch.  ``rounds`` bounds the cycle: a link
        #: that corrupts every response *differently* at the same position
        #: (so the kind never matches) must not re-fetch forever.  A
        #: partition lives in exactly one stream, so entries are disjoint
        #: across workers — but the DICT is shared, so mutation stays
        #: under _corrupt_lock like the spans map.
        self._corrupt_suspects: "Dict[int, Tuple[int, str, int]]" = {}
        self._corrupt_lock = threading.Lock()
        #: (partition, start) -> lost-span record, for every offset range
        #: the log mutated out from under this scan (retention race,
        #: truncation after unclean election, resume below log-start) —
        #: or, seeded from a snapshot, out from under a previous run.
        #: Same sharing discipline as _corrupt_spans.
        self._lost_spans: "Dict[Tuple[int, int], dict]" = {}
        self._lost_lock = threading.Lock()
        #: partition -> highest partition_leader_epoch observed (record-batch
        #: headers, ListOffsets v4+ responses, checkpoint seeds).  Sent as
        #: current_leader_epoch on flexible Fetch/ListOffsets so a stale
        #: leader fences us instead of silently serving a truncated log;
        #: a REGRESSION in observed epochs triggers the OffsetForLeaderEpoch
        #: divergence check.  Guarded by _epoch_lock (shared across worker
        #: streams, same as the spans maps).
        self._leader_epochs: Dict[int, int] = {}
        #: partition -> highest broker-reported log_start_offset (Fetch v5+
        #: responses, ListOffsets earliest probes) — checkpointed so resume
        #: can detect a cursor below the live log start before fetch #1.
        self._log_starts: Dict[int, int] = {}
        self._epoch_lock = threading.Lock()
        # librdkafka-name knobs this client honors (others warned+ignored).
        self.max_wait_ms = int(overrides.pop("fetch.wait.max.ms", 100))
        self.min_bytes = int(overrides.pop("fetch.min.bytes", 1))
        self.max_bytes = int(overrides.pop("fetch.max.bytes", 64 << 20))
        # receive.message.max.bytes bounds whole responses in librdkafka;
        # honoring it as a response-budget cap keeps the operational intent.
        recv_max = overrides.pop("receive.message.max.bytes", None)
        if recv_max is not None:
            self.max_bytes = min(self.max_bytes, int(recv_max))
        self.partition_max_bytes = int(
            overrides.pop("max.partition.fetch.bytes", 8 << 20)
        )
        self.verify_crc = overrides.pop("check.crcs", "false").lower() == "true"
        self.timeout_s = (
            float(overrides.pop("socket.timeout.ms", timeout_s * 1000.0))
            / 1000.0
        )
        #: Pause between fetch rounds when nothing progressed (leader
        #: churn, budget starvation) — librdkafka's fetch.error.backoff.ms.
        self.error_backoff_ms = int(
            overrides.pop("fetch.error.backoff.ms", self.max_wait_ms)
        )
        #: Transport-fault recovery: reconnect pacing (retry.backoff.ms,
        #: reconnect.backoff.ms, reconnect.backoff.max.ms) and the
        #: per-partition retry budget (transport.retry.budget) that gates
        #: the degraded transition.
        self.retry_config = TransportRetryConfig.from_overrides(overrides)
        family_name = overrides.pop("broker.address.family", "any").lower()
        try:
            family = {
                "any": 0,
                "v4": socket.AF_INET,
                "v6": socket.AF_INET6,
            }[family_name]
        except KeyError:
            raise ValueError(
                f"broker.address.family {family_name!r} invalid "
                "(any, v4, v6)"
            ) from None
        self._sock_opts = SocketOptions(
            connect_timeout_s=float(
                overrides.pop("socket.connection.setup.timeout.ms", 30_000)
            ) / 1000.0,
            family=family,
            keepalive=(
                overrides.pop("socket.keepalive.enable", "false").lower()
                == "true"
            ),
            nodelay=(
                overrides.pop("socket.nagle.disable", "true").lower()
                == "true"
            ),
            sndbuf=int(overrides.pop("socket.send.buffer.bytes", 0)),
            rcvbuf=int(overrides.pop("socket.receive.buffer.bytes", 0)),
        )
        # TLS, via the same librdkafka property names the reference's --ssl
        # feature would use (Cargo.toml:19 features=["ssl"]).
        self._ssl_context = None
        protocol = overrides.pop("security.protocol", "plaintext").lower()
        ca_location = overrides.pop("ssl.ca.location", None)
        verify_certs = (
            overrides.pop("enable.ssl.certificate.verification", "true").lower()
            == "true"
        )
        self._sasl: "Optional[Tuple[str, str, str]]" = None
        mechanism = overrides.pop("sasl.mechanism", "PLAIN").upper()
        sasl_user = overrides.pop("sasl.username", None)
        sasl_pass = overrides.pop("sasl.password", None)
        if protocol in ("sasl_plaintext", "sasl_ssl"):
            if mechanism != "PLAIN" and mechanism not in kc.SCRAM_MECHANISMS:
                raise ValueError(
                    f"sasl.mechanism {mechanism!r} unsupported "
                    "(PLAIN, SCRAM-SHA-256, SCRAM-SHA-512)"
                )
            if sasl_user is None or sasl_pass is None:
                raise ValueError(
                    "sasl_plaintext/sasl_ssl require sasl.username and "
                    "sasl.password"
                )
            self._sasl = (mechanism, sasl_user, sasl_pass)
        elif sasl_user is not None or sasl_pass is not None:
            log.warning(
                "sasl.username/sasl.password ignored: security.protocol is "
                "%r (use sasl_plaintext or sasl_ssl)", protocol,
            )
        if protocol in ("ssl", "tls", "sasl_ssl"):
            import ssl as _ssl

            # ssl.ca.location REPLACES the trust store (librdkafka semantics:
            # pinning a private CA must not keep accepting public CAs).
            ctx = _ssl.create_default_context(cafile=ca_location)
            if not verify_certs:
                ctx.check_hostname = False
                ctx.verify_mode = _ssl.CERT_NONE
            self._ssl_context = ctx
        elif protocol not in ("plaintext", "sasl_plaintext"):
            raise ValueError(
                f"security.protocol {protocol!r} unsupported "
                "(plaintext, ssl, sasl_plaintext, sasl_ssl)"
            )
        for k in overrides:
            if k in KNOWN_NOOP_PROPERTIES:
                log.debug("property %r accepted (no effect in this client)", k)
            else:
                log.warning("ignoring unsupported consumer property %r", k)

        self._bootstrap = parse_bootstrap(bootstrap_servers)
        self._conn_lock = threading.Lock()
        self._conns: Dict[Tuple[str, int], BrokerConnection] = {}
        #: Hosts that slammed the connection on ApiVersions (pre-0.10): the
        #: reconnect skips the handshake instead of looping.
        self._assume_legacy: "set[Tuple[str, int]]" = set()
        self._brokers: Dict[int, Tuple[str, int]] = {}
        self._leaders: Dict[int, int] = {}
        self._watermarks: Optional[Tuple[Dict[int, int], Dict[int, int]]] = None
        #: partition -> reason, for every partition dropped from a scan
        #: after exhausting its transport/protocol retry budget.  Sharded
        #: scans AND parallel-ingest workers (parallel/ingest.py) run
        #: several batches() streams against one source, so this
        #: accumulates across streams (each partition belongs to exactly
        #: one stream, but the dict is shared: writes hold
        #: _degraded_lock); the engine snapshots it per scan.
        self.degraded: Dict[int, str] = {}
        self._degraded_lock = threading.Lock()
        #: Serializes the read-modify-write growth of partition_max_bytes:
        #: concurrent streams each learning "batch exceeds fetch size"
        #: must not lose each other's doubling.  Reads stay lock-free —
        #: a stale size only costs one extra growth round.
        self._fetch_grow_lock = threading.Lock()
        self._load_metadata()

    def degraded_partitions(self) -> Dict[int, str]:
        with self._degraded_lock:
            return dict(self.degraded)

    # -- corruption accounting ------------------------------------------------

    def corruption_spans(self) -> "list[dict]":
        """Every skipped poison span as a JSON-safe record (checkpoint
        metadata format; `seed_corrupt_spans` round-trips it)."""
        with self._corrupt_lock:
            return [dict(s) for s in self._corrupt_spans.values()]

    def corruption_stats(self) -> "Dict[int, dict]":
        """Per-partition corruption accounting: frame/record/byte counts,
        per-kind breakdown, and the span list — the engine snapshots this
        into `ScanResult.corrupt_partitions`."""
        out: "Dict[int, dict]" = {}
        for s in self.corruption_spans():
            d = out.setdefault(
                s["partition"],
                {
                    "frames": 0, "records": 0, "bytes": 0,
                    "quarantined": 0, "kinds": {}, "spans": [],
                },
            )
            d["frames"] += s.get("frames", 1)
            d["records"] += s.get("records", 0)
            d["bytes"] += s.get("bytes", 0)
            d["quarantined"] += 1 if s.get("quarantined") else 0
            d["kinds"][s["kind"]] = d["kinds"].get(s["kind"], 0) + 1
            d["spans"].append(s)
        return out

    def _note_corrupt(
        self,
        p: int,
        anchor: int,
        err: "kc.CorruptFrameError",
        claimed_end: int,
        resume_offset: int,
        num_records: int,
        raw: bytes,
    ) -> Optional[int]:
        """Book one corrupt-frame sighting at scan position ``anchor``.

        Returns the offset to skip the partition to; ``None`` when the
        caller must stop this partition's round so the span is re-fetched
        once (first sighting — an in-flight bit flip would not reproduce);
        ``-1`` when the span is deterministically corrupt but gives no
        skip bound (the caller degrades the partition).  Raises the
        classified error under the ``fail`` policy once deterministic.
        """
        key = (p, anchor)
        with self._corrupt_lock:
            known = self._corrupt_spans.get(key)
            prev = self._corrupt_suspects.get(p)
        if known is not None:
            return int(known["skip_to"])  # seeded/already-skipped span
        rounds = prev[2] + 1 if prev is not None and prev[0] == anchor else 1
        deterministic = (
            prev is not None
            and prev[0] == anchor
            and (prev[1] == err.kind or rounds > _MAX_SUSPECT_ROUNDS)
        )
        if not deterministic:
            # Suspect an in-flight flip.  Leaving the partition's offset
            # untouched makes the next round re-fetch the identical span —
            # one extra fetch on a healthy connection, none of the
            # transport retry budget.  A matching kind on the re-fetch
            # (the common case) settles it in one round; a link that
            # mutates the damage differently every round is settled by the
            # rounds bound instead of re-fetching forever.
            with self._corrupt_lock:
                self._corrupt_suspects[p] = (anchor, err.kind, rounds)
            obs_metrics.CORRUPT_REFETCHES.inc()
            obs_events.emit(
                "corrupt_suspect", partition=p, anchor=anchor, kind=err.kind
            )
            log.warning(
                "partition %d: suspect corrupt frame at offset %d (%s); "
                "re-fetching once to rule out an in-flight bit flip",
                p, anchor, err.kind,
            )
            return None
        # Identical failure on the re-fetched bytes (or the re-fetch
        # budget ran out): deterministic corruption.  Apply policy.
        with self._corrupt_lock:
            self._corrupt_suspects.pop(p, None)
        err.partition = p
        if self.corruption.policy == "fail":
            raise err
        skip_to = kc.preferred_skip_offset(anchor, resume_offset, claimed_end)
        span_rec = {
            "partition": p,
            "anchor": anchor,
            "skip_to": int(skip_to),  # -1 when the span gave no bound
            "kind": err.kind,
            "base_offset": int(err.base_offset),
            "frames": 1,
            "records": int(max(num_records, 0)),
            "bytes": len(raw),
            "quarantined": False,
        }
        if self._quarantine is not None:
            sidecar = self._quarantine.spool(
                topic=self.topic,
                partition=p,
                anchor=anchor,
                raw=raw,
                classification=err.kind,
                base_offset=err.base_offset,
                offset_start=err.base_offset,
                offset_end=claimed_end,
                crc_expected=err.crc_expected,
                crc_actual=err.crc_actual,
                error=str(err),
            )
            span_rec["quarantined"] = True
            if sidecar is not None:
                obs_metrics.CORRUPT_QUARANTINED.inc()
        obs_metrics.CORRUPT_FRAMES.labels(kind=err.kind).inc()
        obs_metrics.CORRUPT_RECORDS.inc(span_rec["records"])
        obs_metrics.CORRUPT_BYTES.inc(len(raw))
        obs_events.emit(
            "corrupt_frame",
            partition=p,
            anchor=anchor,
            skip_to=span_rec["skip_to"],
            kind=err.kind,
            action=self.corruption.policy,
            quarantined=span_rec["quarantined"],
        )
        log.error(
            "partition %d: deterministically corrupt frame at offset %d "
            "(%s): %s — %s",
            p, anchor, err.kind, err,
            "quarantined + skipped"
            if span_rec["quarantined"] else "skipped",
        )
        with self._corrupt_lock:
            self._corrupt_spans[key] = span_rec
        return span_rec["skip_to"]

    # -- log-mutation (data-loss) accounting ---------------------------------

    def lost_spans(self) -> "List[dict]":
        """Every offset range the log mutated out from under this scan (or,
        seeded, a predecessor's scan), as JSON-safe dicts."""
        with self._lost_lock:
            return [dict(s) for s in self._lost_spans.values()]

    def loss_stats(self) -> Dict[int, dict]:
        """Per-partition data-loss rollup, shaped like corruption_stats():
        {partition: {records, ranges, reasons, authoritative, spans}}.
        ``authoritative`` is False when any span came from truncation —
        records already folded at those offsets were replaced, so the
        partition's counts describe a log that no longer exists."""
        out: Dict[int, dict] = {}
        with self._lost_lock:
            spans = [dict(s) for s in self._lost_spans.values()]
        for s in sorted(spans, key=lambda s: (s["partition"], s["start"])):
            d = out.setdefault(
                s["partition"],
                {
                    "records": 0,
                    "ranges": 0,
                    "reasons": {},
                    "authoritative": True,
                    "spans": [],
                },
            )
            d["records"] += s["records"]
            d["ranges"] += 1
            d["reasons"][s["reason"]] = d["reasons"].get(s["reason"], 0) + 1
            if s["reason"] == "truncation":
                d["authoritative"] = False
            d["spans"].append(s)
        return out

    def _note_lost(
        self, p: int, start: int, end: int, reason: str
    ) -> None:
        """Book the lost range [start, end) on partition ``p``: per-reason
        metrics, a lost-span record, a ``log_lost`` event — and, under the
        ``fail`` policy, the classified abort.  Idempotent per (partition,
        start): a re-detected span (seeded from a checkpoint, or re-entered
        after a metadata reload) is never double-counted."""
        records = int(end) - int(start)
        if records <= 0:
            return
        span_rec = {
            "partition": int(p),
            "start": int(start),
            "end": int(end),
            "records": records,
            "reason": reason,
        }
        with self._lost_lock:
            key = (int(p), int(start))
            if key in self._lost_spans:
                return
            self._lost_spans[key] = span_rec
        obs_metrics.LOG_LOST_RECORDS.labels(reason=reason).inc(records)
        obs_metrics.LOG_LOST_RANGES.labels(reason=reason).inc()
        obs_events.emit(
            "log_lost",
            partition=int(p),
            start=int(start),
            end=int(end),
            records=records,
            reason=reason,
            action=self.data_loss.policy,
        )
        log.error(
            "partition %d: %d record(s) at [%d, %d) lost to %s — %s",
            p, records, start, end, reason,
            "aborting (--on-data-loss fail)"
            if self.data_loss.policy == "fail" else "continuing",
        )
        if self.data_loss.policy == "fail":
            raise DataLossError(
                f"partition {p}: {records} record(s) at [{start}, {end}) "
                f"lost to {reason} (--on-data-loss fail)",
                span_rec,
            )

    # -- leader-epoch fencing (KIP-320) --------------------------------------

    def _observe_epoch(self, p: int, epoch: int) -> bool:
        """Track the highest leader epoch seen for ``p``.  Returns True when
        ``epoch`` REGRESSES below the tracked one — data from a stale
        replica / pre-election log, which callers answer with the
        OffsetForLeaderEpoch divergence check."""
        if epoch < 0:
            return False
        with self._epoch_lock:
            cur = self._leader_epochs.get(p, -1)
            if epoch > cur:
                self._leader_epochs[p] = epoch
            return epoch < cur

    def _observe_log_start(self, p: int, offset: int) -> None:
        """Track the highest broker-reported log start (retention floor)."""
        if offset < 0:
            return
        with self._epoch_lock:
            if offset > self._log_starts.get(p, -1):
                self._log_starts[p] = offset

    def _epoch_for(self, p: int) -> int:
        """Tracked epoch to send as current_leader_epoch (-1 = unknown)."""
        with self._epoch_lock:
            return self._leader_epochs.get(p, -1)

    def _clear_epoch(self, p: int) -> None:
        """Forget a fenced epoch so the next fetch sends -1 (unfenced) and
        re-learns the post-election epoch from the data it returns."""
        with self._epoch_lock:
            self._leader_epochs.pop(p, None)

    def check_divergence(
        self, p: int, cursor: int, ask_epoch: int
    ) -> Optional[int]:
        """OffsetForLeaderEpoch (API 23) probe: where does the broker's log
        for ``ask_epoch`` end?  Returns that end offset when it falls BELOW
        ``cursor`` (the log we scanned was truncated there), else None —
        also None when the probe cannot run (broker predates API 23, or the
        round trip fails): an unverifiable cursor is reported, not guessed
        at."""
        if ask_epoch < 0 or p not in self._leaders:
            return None
        obs_metrics.LOG_DIVERGENCE_CHECKS.inc()
        try:
            conn = self._leader_conn(p)
            v = self._version(conn, kc.API_OFFSET_FOR_LEADER_EPOCH)
            if (
                conn.api_versions is not None
                and kc.API_OFFSET_FOR_LEADER_EPOCH not in conn.api_versions
            ):
                log.warning(
                    "partition %d: broker does not speak "
                    "OffsetForLeaderEpoch; cannot verify cursor %d against "
                    "epoch %d", p, cursor, ask_epoch,
                )
                return None
            r = conn.request(
                kc.API_OFFSET_FOR_LEADER_EPOCH,
                v,
                kc.encode_offset_for_leader_epoch_request(
                    self.topic,
                    [(p, self._epoch_for(p), ask_epoch)],
                    v,
                ),
            )
            decoded = kc.decode_offset_for_leader_epoch_response(r, v)
        except (OSError, kc.KafkaProtocolError) as e:
            log.warning(
                "partition %d: OffsetForLeaderEpoch probe failed: %s", p, e
            )
            return None
        got = decoded.get(p)
        if got is None:
            return None
        err, end_epoch, end_offset = got
        if err or end_offset < 0:
            log.warning(
                "partition %d: OffsetForLeaderEpoch error %d "
                "(epoch %d)", p, err, ask_epoch,
            )
            return None
        obs_events.emit(
            "divergence_check",
            partition=int(p),
            ask_epoch=int(ask_epoch),
            end_epoch=int(end_epoch),
            end_offset=int(end_offset),
            cursor=int(cursor),
            diverged=bool(end_offset < cursor),
        )
        if end_offset < cursor:
            return int(end_offset)
        return None

    # -- connections ---------------------------------------------------------

    def _connect(self, host: str, port: int) -> BrokerConnection:
        key = (host, port)
        with self._conn_lock:
            conn = self._conns.get(key)
            if conn is None:
                conn = BrokerConnection(
                    host,
                    port,
                    self.timeout_s,
                    ssl_context=self._ssl_context,
                    sasl=self._sasl,
                    sock_opts=self._sock_opts,
                )
                self._conns[key] = conn
            return conn

    def _any_conn(self) -> BrokerConnection:
        errors = []
        for host, port in self._bootstrap:
            try:
                return self._connect(host, port)
            except OSError as e:
                errors.append(f"{host}:{port}: {e}")
        raise kc.KafkaProtocolError(
            "could not reach any bootstrap server: " + "; ".join(errors)
        )

    def _leader_conn(self, partition: int) -> BrokerConnection:
        node = self._leaders[partition]
        host, port = self._brokers[node]
        return self._connect(host, port)

    def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()

    # -- protocol version negotiation ---------------------------------------

    #: Preferred-first version candidates per API.  Metadata v5 is the floor
    #: on Kafka 4.0 brokers (KIP-896 removed pre-2.1 versions); v1 keeps
    #: very old brokers working.  The last entry doubles as the legacy
    #: default when the broker predates ApiVersions.  The leading entries
    #: are the flexible (KIP-482 tagged/compact) versions — preferred when
    #: the broker's advertised range covers them, and required once a
    #: future KIP-896-style floor raise drops the classic encodings.
    _CANDIDATES = {
        kc.API_METADATA: ("Metadata", (12, 5, 1)),
        kc.API_LIST_OFFSETS: ("ListOffsets", (7, 1)),
        kc.API_FETCH: ("Fetch", (12, 4)),
        kc.API_OFFSET_FOR_LEADER_EPOCH: ("OffsetForLeaderEpoch", (4, 3)),
    }

    def _evict(self, conn: BrokerConnection) -> None:
        """Close and forget a connection whose stream may be dead/desynced
        so the next use reconnects fresh."""
        conn.close()
        with self._conn_lock:
            if self._conns.get((conn.host, conn.port)) is conn:
                del self._conns[(conn.host, conn.port)]
        obs_metrics.CONNECTION_EVICTIONS.inc()
        obs_events.emit(
            "connection_evicted", host=conn.host, port=conn.port
        )

    def _version(self, conn: BrokerConnection, api_key: int) -> int:
        if conn.api_versions is None:
            if (conn.host, conn.port) in self._assume_legacy:
                conn.api_versions = {}
            else:
                # KIP-511 downgrade dance: offer the flexible v3 first; a
                # broker that doesn't speak it answers UNSUPPORTED_VERSION
                # in v0 format (brokers parse only the first two header
                # fields of an unknown-version ApiVersions request), and
                # the client retries at v0.  This is what survives a
                # future floor raise that drops ApiVersions v0.
                for av in (3, 0):
                    try:
                        r = conn.request(
                            kc.API_VERSIONS, av,
                            kc.encode_api_versions_request(av),
                        )
                    except kc.KafkaProtocolError as e:
                        # Pre-0.10 brokers slam the connection on the
                        # unknown request: remember the host as legacy (so
                        # the caller's retry skips the handshake) and
                        # surface the failure — the stream is dead either
                        # way.
                        self._evict(conn)
                        if "closed the connection" in str(e):
                            self._assume_legacy.add((conn.host, conn.port))
                        raise
                    except OSError as e:
                        # Transient socket failure: evict (dead/desynced
                        # stream) but do NOT guess legacy — the retry
                        # re-handshakes.
                        self._evict(conn)
                        raise kc.KafkaProtocolError(
                            f"ApiVersions handshake failed: {e}"
                        ) from e
                    try:
                        conn.api_versions = kc.decode_api_versions_response(
                            r, av
                        )
                        break
                    except kc.UnsupportedVersionError:
                        if av == 0:
                            # v0 itself rejected: genuinely ancient broker.
                            log.warning(
                                "ApiVersions rejected; assuming legacy broker"
                            )
                            conn.api_versions = {}
                        continue  # downgrade v3 -> v0
                    except kc.KafkaProtocolError as e:
                        # A cleanly-decoded non-version error: old broker.
                        log.warning(
                            "ApiVersions rejected (%s); assuming legacy broker", e
                        )
                        conn.api_versions = {}
                        break
        name, candidates = self._CANDIDATES[api_key]
        ranges = conn.api_versions
        if not ranges or api_key not in ranges:
            return candidates[-1]
        lo, hi = ranges[api_key]
        for v in candidates:
            if lo <= v <= hi:
                return v
        raise kc.KafkaProtocolError(
            f"broker supports {name} versions [{lo}, {hi}] but this client "
            f"implements {sorted(candidates)}"
        )

    # -- topology (src/kafka.rs:60-72) --------------------------------------

    def _load_metadata(self, retries: int = 5) -> None:
        import time

        last_issue = ""
        for attempt in range(retries):
            conn = self._any_conn()
            try:
                v = self._version(conn, kc.API_METADATA)
            except kc.KafkaProtocolError as e:
                # A pre-0.10 broker slams the connection on ApiVersions;
                # _version evicted it and remembered the host as legacy, so
                # the retry reconnects and skips the handshake.
                if attempt + 1 >= retries:
                    raise
                log.warning("ApiVersions handshake failed (%s); retrying", e)
                continue
            try:
                r = conn.request(
                    kc.API_METADATA, v,
                    kc.encode_metadata_request([self.topic], v),
                )
                md = kc.decode_metadata_response(r, v)
            except (OSError, kc.KafkaProtocolError) as e:
                # A cached bootstrap connection died (broker restart) or
                # the stream desynced: evict so the retry reconnects fresh
                # instead of hitting the same dead socket forever.
                self._evict(conn)
                if attempt + 1 >= retries:
                    raise kc.KafkaProtocolError(
                        f"metadata request failed: {e}"
                    ) from e
                log.warning("metadata request failed (%s); retrying", e)
                continue
            topic_md = next((t for t in md.topics if t.name == self.topic), None)
            if topic_md is None or topic_md.error == kc.ERR_UNKNOWN_TOPIC_OR_PARTITION:
                raise SystemExit("Topic not found!")  # src/kafka.rs:62
            if topic_md.error:
                raise kc.KafkaProtocolError(
                    f"metadata error {topic_md.error} for topic {self.topic!r}"
                )
            # Leaderless partitions (error set or leader == -1) happen during
            # elections; retry briefly instead of failing later with KeyError.
            bad = [
                p for p in topic_md.partitions
                if p.error or p.leader < 0 or p.leader not in md.brokers
            ]
            if not bad:
                # Commit brokers+leaders together, and only on full
                # success: a recovery-path reload that fails partway (half
                # -up broker, leaderless election) must leave the previous
                # topology fully intact, not a half-new brokers table that
                # routes still-healthy partitions into transport failures.
                self._brokers = md.brokers
                self._leaders = {p.partition: p.leader for p in topic_md.partitions}
                return
            last_issue = ", ".join(
                f"partition {p.partition} (error={p.error}, leader={p.leader})"
                for p in bad
            )
            log.warning("metadata not ready (%s), retry %d", last_issue, attempt + 1)
            time.sleep(min(0.2 * (attempt + 1), 1.0))
        raise kc.KafkaProtocolError(
            f"no usable leader for topic {self.topic!r}: {last_issue}"
        )

    def _reload_metadata(self) -> bool:
        """Metadata refresh that tolerates an unreachable cluster: during
        transport recovery a failed reload must not abort the scan — the
        next round retries against the stale topology, and the per-partition
        retry budget bounds how long that can go on."""
        obs_metrics.METADATA_RELOADS.inc()
        try:
            self._load_metadata()
            obs_events.emit("metadata_reload", ok=True)
            return True
        except (OSError, kc.KafkaProtocolError) as e:
            log.warning(
                "metadata reload failed (%s); keeping stale topology", e
            )
            obs_events.emit("metadata_reload", ok=False, error=str(e))
            return False
        except SystemExit:
            # _load_metadata's "Topic not found!" exit is an init-time
            # contract (src/kafka.rs:62).  Mid-scan it is a transient: a
            # restarting broker can answer metadata with
            # UNKNOWN_TOPIC_OR_PARTITION before it re-syncs topic state,
            # and the scan already proved the topic exists.
            log.warning(
                "metadata reload says topic %r unknown (broker still "
                "syncing?); keeping stale topology", self.topic,
            )
            return False

    def partitions(self) -> List[int]:
        return sorted(self._leaders)

    def _list_offsets(self, ts: int) -> Dict[int, int]:
        """One ListOffsets query (timestamp or earliest/latest sentinel)
        across all partitions, grouped by leader."""
        out: Dict[int, int] = {}
        by_leader: Dict[int, List[int]] = {}
        for p, leader in self._leaders.items():
            by_leader.setdefault(leader, []).append(p)
        for leader, parts in by_leader.items():
            host, port = self._brokers[leader]
            conn = self._connect(host, port)
            lo_v = self._version(conn, kc.API_LIST_OFFSETS)
            try:
                r = conn.request(
                    kc.API_LIST_OFFSETS,
                    lo_v,
                    kc.encode_list_offsets_request(
                        self.topic, [(p, ts) for p in parts], lo_v
                    ),
                )
                decoded = kc.decode_list_offsets_response(r, lo_v)
            except (OSError, kc.KafkaProtocolError) as e:
                # Evict the dead/desynced cached connection before
                # surfacing the failure so a caller's retry reconnects.
                self._evict(conn)
                raise kc.KafkaProtocolError(
                    f"ListOffsets on {host}:{port} failed: {e}"
                ) from e
            for pid, (err, off, epoch) in decoded.items():
                if err:
                    raise kc.KafkaProtocolError(
                        f"ListOffsets error {err} for partition {pid}"
                    )
                self._observe_epoch(pid, epoch)
                if ts == kc.EARLIEST_TIMESTAMP:
                    self._observe_log_start(pid, off)
                out[pid] = off
        return out

    def watermarks(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        if self._watermarks is not None:
            return self._watermarks
        self._watermarks = (
            self._list_offsets(kc.EARLIEST_TIMESTAMP),
            self._list_offsets(kc.LATEST_TIMESTAMP),
        )
        return self._watermarks

    def offsets_for_timestamp(self, ts_ms: int) -> Dict[int, int]:
        """Per-partition earliest offset whose record timestamp >= ts_ms
        (ListOffsets timestamp lookup); partitions with no such record map
        to their end watermark, so a subsequent scan reads nothing there."""
        _, end = self.watermarks()
        return {
            pid: (off if off >= 0 else end[pid])
            for pid, off in self._list_offsets(ts_ms).items()
        }

    def _earliest_offset(self, partition: int) -> int:
        """Fresh earliest offset for one partition (OFFSET_OUT_OF_RANGE
        recovery when retention advances mid-scan)."""
        return self._list_offsets(kc.EARLIEST_TIMESTAMP)[partition]

    # -- the read loop (src/kafka.rs:74-137, batched) ------------------------

    #: The engine may hand this source a packing.FusedPackSink: accepted
    #: record sets then decode→pack straight into wire-v4 rows (yielded as
    #: packing.PackedRow) instead of materializing RecordBatch columns.
    supports_fused_sink = True

    def batches(
        self,
        batch_size: int,
        partitions: Optional[List[int]] = None,
        start_at: Optional[Dict[int, int]] = None,
        sink=None,
    ) -> Iterator[RecordBatch]:
        # Fetch connections are private to this iterator: sharded scans
        # and parallel ingest (parallel/ingest.py) run one batches()
        # stream per shard/worker from worker threads, and the pipelined
        # send/read halves cannot share a socket with another stream
        # (responses would be claimed by the wrong reader).  Everything
        # scan-shared that a stream can mutate — degraded, the corruption
        # spans/suspects, partition_max_bytes growth — is lock-guarded;
        # per-stream state (offsets, streaks, inflight) lives below.
        own_conns: Dict[int, BrokerConnection] = {}
        pools: "list" = []
        try:
            yield from self._batches_impl(
                batch_size, partitions, start_at, own_conns, pools, sink
            )
        finally:
            # Drain worker threads BEFORE closing their sockets: a close
            # under an active reader is a fd-reuse race (and outright
            # thread-unsafe on SSLSocket).  Workers unblock within the
            # socket timeout at worst.
            for pl in pools:
                pl.shutdown(wait=True, cancel_futures=True)
            for c in own_conns.values():
                c.close()

    def _batches_impl(
        self,
        batch_size: int,
        partitions: Optional[List[int]],
        start_at: Optional[Dict[int, int]],
        own_conns: "Dict[int, BrokerConnection]",
        pools: "list",
        sink=None,
    ) -> Iterator[RecordBatch]:
        start, end = self.watermarks()
        parts = sorted(partitions) if partitions is not None else self.partitions()
        next_offset = {p: start[p] for p in parts}
        if start_at:
            for p in parts:
                if p in start_at:
                    cursor = int(start_at[p])
                    if cursor < next_offset[p]:
                        # The log start passed the caller's cursor before
                        # this stream's first fetch (retention between
                        # follow polls, or between cursor save and stream
                        # open).  The gap [cursor, start) was never
                        # readable here — book it, never skip silently.
                        # Idempotent with the resume gate: validate_resume
                        # re-anchors its offsets in place, and _note_lost
                        # dedups on (partition, start) regardless.
                        self._note_lost(
                            p, cursor, next_offset[p], "retention"
                        )
                    else:
                        next_offset[p] = cursor
        remaining = {p for p in parts if next_offset[p] < end[p]}

        # Accumulate RecordBatch *chunks* (one per accepted wire frame) and
        # re-split to batch_size at flush; offsets ride along for snapshot
        # resume.  Chunks come from the native frame decoder when available
        # (the Python per-record generator is ~100x slower).
        #
        # With a fused ``sink`` installed (and the native shim loaded) the
        # pend/resplit chain is replaced wholesale: accepted record sets
        # decode→pack straight into the sink's wire-v4 rows
        # (sink.append_record_set — no SoA columns, no re-batching copy),
        # fallback chunks (compressed/legacy/salvaged/python-decoded
        # frames) enter the SAME rows through sink.append_batch so the
        # greedy batch_size boundaries — and therefore the packed bytes —
        # stay byte-identical to the chained path, and ``flush`` yields
        # completed packing.PackedRow items instead of RecordBatches.
        pend: List[RecordBatch] = []
        pend_count = 0

        def flush(force: bool):
            nonlocal pend, pend_count
            if sink is not None:
                if force:
                    sink.flush()
                yield from sink.take_completed()
                return
            if not (pend_count >= batch_size or (force and pend_count)):
                return
            out, pend, pend_count = RecordBatch.resplit(
                pend, batch_size, force
            )
            yield from out

        def push_chunk(chunk: RecordBatch, reason: str) -> None:
            nonlocal pend_count
            if not len(chunk):
                return
            if sink is not None:
                sink.append_batch(chunk, reason)
                return
            pend.append(chunk)
            pend_count += len(chunk)

        def accept_records(
            soa: "dict[str, np.ndarray]", p: int, reason: str
        ) -> int:
            """Push the records of a decoded SoA chunk that fall in
            [next_offset[p], end[p]) and advance next_offset; returns the
            accepted count (``reason`` books them on a fused sink).
            Offsets increase within a Kafka record set, so the in-range
            run is a contiguous slice found by searchsorted
            (columns become views, no per-column mask copies); a broker
            violating the ordering contract falls back to a boolean mask."""
            offs = soa["offsets"]
            if len(offs) == 0:
                return 0
            a, b = next_offset[p], end[p]
            if bool((offs[1:] > offs[:-1]).all()):
                lo = int(np.searchsorted(offs, a, "left"))
                hi = int(np.searchsorted(offs, b, "left"))
                if hi <= lo:
                    return 0
                sel: "slice | np.ndarray" = slice(lo, hi)
                cnt = hi - lo
                last = int(offs[hi - 1])
            else:
                idx = np.flatnonzero((offs >= a) & (offs < b))
                if len(idx) == 0:
                    return 0
                sel = idx
                cnt = len(idx)
                last = int(offs[idx[-1]])
            push_chunk(_chunk_to_batch(soa, sel, p), reason)
            next_offset[p] = last + 1
            return cnt

        use_native_decode = self.use_native_hashing and native.native_available()
        if sink is not None and not use_native_decode:
            # Fused sink requested but the native decoder is off: the whole
            # stream degrades to the decoded-batch python chain.  Book the
            # bypass ONCE on the sink and the counter, with the cached load
            # reason, and log it — never silently.
            reason = (
                f"native-{native.native_status()[1]}"
                if self.use_native_hashing else "native-off"
            )
            sink.fallbacks[reason] = sink.fallbacks.get(reason, 0) + 1
            obs_metrics.FUSED_FALLBACK.labels(reason=reason).inc()
            log.warning(
                "fused decode→pack unavailable (%s); falling back to the "
                "python decode chain", reason,
            )
            sink = None

        import time

        error_streak: Dict[int, int] = {p: 0 for p in parts}
        max_error_streak = 100
        # Transport-fault recovery: reconnect pacing shared by the whole
        # stream, budget per partition.  A partition whose budget runs out
        # DEGRADES (dropped + reported via self.degraded) instead of
        # aborting the scan and discarding every other partition's work.
        backoff = Backoff(self.retry_config)
        budget = PartitionRetryBudget(self.retry_config.retry_budget)
        # Backoff is PER LEADER, not per round: one dead broker must not
        # throttle the still-healthy leaders' throughput, so its partitions
        # are deferred past a retry deadline while everyone else streams.
        leader_fail_streak: Dict[int, int] = {}
        leader_retry_at: Dict[int, float] = {}

        def degrade(p: int, reason: str) -> None:
            if p not in remaining:
                return
            log.error("partition %d degraded: %s", p, reason)
            remaining.discard(p)  # stream-local (this worker's partitions)
            with self._degraded_lock:  # scan-shared across worker streams
                self.degraded[p] = reason
            obs_events.emit("partition_degraded", partition=p, reason=reason)
        # Consecutive fetches for a partition that neither consumed records
        # nor advanced the offset (possible under response-budget pressure
        # from sibling partitions) — bounded so a pathological broker can't
        # livelock the scan.  The bound scales with partition count: the
        # rotated fetch order guarantees a starved partition heads the
        # request within len(parts) rounds.
        stall_streak: Dict[int, int] = {p: 0 for p in parts}
        max_stall = max(max_error_streak, 4 * len(parts))

        inflight: "Dict[int, tuple]" = {}
        conn_lock = threading.Lock()

        def own_conn(leader: int) -> BrokerConnection:
            # Keyed by LEADER id, not (host, port): fetch_leader threads run
            # per leader, and two leader ids advertising the same address
            # (load balancer, port forward) must NOT share a socket — the
            # pipelined send/read halves from two threads would race for
            # each other's response bytes.
            addr = self._brokers.get(leader)
            if addr is None:
                # A recovery-path metadata reload can drop a broker while
                # its partitions still point at it (leaderless election
                # window): a protocol error here books as a transport
                # failure instead of a KeyError aborting the scan.
                raise kc.KafkaProtocolError(
                    f"leader {leader} missing from cluster metadata"
                )
            host, port = addr
            with conn_lock:
                c = own_conns.get(leader)
                if c is not None and (c.host, c.port) != (host, port):
                    # Leader moved (metadata reload): reconnect.
                    c.close()
                    own_conns.pop(leader, None)
                    c = None
                if c is not None:
                    return c
            # Connect OUTSIDE the lock: TCP+TLS+SASL setup can block up to
            # the socket timeout, and one slow broker must not serialize
            # every other leader thread's first round.
            c = BrokerConnection(
                host,
                port,
                self.timeout_s,
                ssl_context=self._ssl_context,
                sasl=self._sasl,
                sock_opts=self._sock_opts,
            )
            with conn_lock:
                winner = own_conns.get(leader)
                if winner is not None:  # lost a (same-leader) race
                    c.close()
                    return winner
                own_conns[leader] = c
            return c

        def fetch_leader(leader: int, lparts: List[int], fetch_round: int):
            """Phase 1 of a round, one leader: (re)send, read, decode —
            ALL the heavy work (socket IO, native scan + record-set
            decode) with no shared-state mutation beyond this leader's
            own connection and inflight slot.  Runs concurrently across
            leaders; phase 2 (the serial loop below) does bookkeeping."""
            conn = own_conn(leader)
            # KIP-74: brokers fill the response budget in request order,
            # so rotate the partition list each round — without this,
            # partitions at the tail of a large sorted list can be
            # starved of response bytes indefinitely.
            lp = sorted(lparts)
            k = fetch_round % len(lp)
            order = lp[k:] + lp[:k]
            # Pipelining: if last round sent ahead for this leader, its
            # response is already in flight.  A stale in-flight
            # (connection changed, or it no longer covers this round's
            # partitions) is drained and discarded — the stream stays
            # ordered either way.
            fl = inflight.pop(leader, None)
            if fl is not None and (
                fl[0] is not conn or not set(lp) <= set(fl[3])
            ):
                try:
                    fl[0].read_response(fl[1])
                except Exception:
                    fl[0].close()
                    with conn_lock:
                        if own_conns.get(leader) is fl[0]:
                            own_conns.pop(leader, None)
                    conn = own_conn(leader)
                fl = None
            if fl is None:
                pmax_sent = self.partition_max_bytes
                fetch_v = self._version(conn, kc.API_FETCH)
                corr = conn.send_request(
                    kc.API_FETCH,
                    fetch_v,
                    kc.encode_fetch_request(
                        self.topic,
                        [
                            (p, next_offset[p], self._epoch_for(p))
                            for p in order
                        ],
                        self.max_wait_ms,
                        self.min_bytes,
                        self.max_bytes,
                        pmax_sent,
                        fetch_v,
                    ),
                )
                fl = (
                    conn,
                    corr,
                    {p: next_offset[p] for p in order},
                    order,
                    pmax_sent,
                )
            conn, corr, sent_offsets, order, pmax_sent = fl
            _t_fetch = _perf_counter()
            with obs_trace.maybe_span("fetch", cat="io"):
                r = conn.read_response(corr)
            # Same window as the span, booked per fetch round — the
            # flight recorder's source-wait track (obs/doctor.py).
            obs_metrics.FETCH_SECONDS.inc(_perf_counter() - _t_fetch)
            fps = kc.decode_fetch_response(r, self._version(conn, kc.API_FETCH))
            obs_metrics.FETCH_REQUESTS.inc()
            obs_metrics.FETCH_BYTES.inc(
                sum(len(fp.records) for fp in fps)
            )
            # Send-ahead: while this response's records decode, let the
            # broker build the NEXT one.  A cheap native header scan of
            # each partition's record set yields the exact offsets
            # processing will arrive at (covered_end, compaction-aware);
            # only clean all-native responses qualify, and a
            # post-processing mismatch discards the speculative response
            # (correctness never depends on the speculation being right).
            spec_sent = False
            #: Clean full-prefix scan results, reused by the decode so
            #: the header (and CRC) walk isn't paid twice.
            scans: "Dict[int, tuple[int, int, int]]" = {}
            if use_native_decode:
                clean = True
                spec: Dict[int, int] = {}
                for fp in fps:
                    p = fp.partition
                    if p not in remaining:
                        continue
                    if fp.error or len(fp.records) == 0:
                        clean = False
                        break
                    nrec, used, covered = native.scan_record_set_native(
                        fp.records, self.verify_crc
                    )
                    # nrec may be 0 with the whole set consumed — a
                    # marker-only (transaction control) stretch still
                    # speculates: covered advances past it.
                    if used != len(fp.records):
                        clean = False
                        break
                    scans[p] = (nrec, used, covered)
                    if covered <= next_offset[p]:
                        clean = False
                        break
                    spec[p] = min(covered, end[p])
                if clean and spec:
                    lp2 = sorted(
                        p for p in order if p in spec and spec[p] < end[p]
                    )
                    if lp2:
                        k2 = (fetch_round + 1) % len(lp2)
                        order2 = lp2[k2:] + lp2[:k2]
                        pmax2 = self.partition_max_bytes
                        fetch_v2 = self._version(conn, kc.API_FETCH)
                        corr2 = conn.send_request(
                            kc.API_FETCH,
                            fetch_v2,
                            kc.encode_fetch_request(
                                self.topic,
                                [
                                    (p, spec[p], self._epoch_for(p))
                                    for p in order2
                                ],
                                self.max_wait_ms,
                                self.min_bytes,
                                self.max_bytes,
                                pmax2,
                                fetch_v2,
                            ),
                        )
                        inflight[leader] = (
                            conn,
                            corr2,
                            {p: spec[p] for p in order2},
                            order2,
                            pmax2,
                        )
                        spec_sent = True
            # Pre-decode the clean full-prefix record sets here (the
            # expensive, GIL-releasing half); masking and state updates
            # stay in phase 2.  Fused-sink streams skip this: their decode
            # IS the pack, and sink appends must run serially in phase-2
            # order (the scan above still powers the send-ahead).
            soas: "Dict[int, tuple]" = {}
            if scans and sink is None:
                _t_dec = _perf_counter()
                with obs_trace.maybe_span("decode", cat="io"):
                    for fp in fps:
                        p = fp.partition
                        if p in scans:
                            soas[p] = native.decode_record_set_native(
                                fp.records, self.verify_crc, prescan=scans[p]
                            )
                obs_metrics.DECODE_SECONDS.inc(_perf_counter() - _t_dec)
            return (leader, fps, scans, soas, spec_sent, order, pmax_sent)

        def fetch_leader_guarded(leader: int, lparts: List[int], fetch_round: int):
            """fetch_leader with transport-failure capture: a reset, hang
            (socket timeout), refused reconnect, or truncated/desynced
            stream tears down this leader's connection — including any
            speculative in-flight fetch riding on it — and returns a
            `_TransportFailure` for phase 2 to book, rather than killing
            the scan."""
            try:
                return fetch_leader(leader, lparts, fetch_round)
            except (OSError, kc.KafkaProtocolError) as e:
                inflight.pop(leader, None)
                with conn_lock:
                    c = own_conns.pop(leader, None)
                if c is not None:
                    c.close()
                log.warning(
                    "transport failure on leader %d (%s): %s",
                    leader, type(e).__name__, e,
                )
                obs_metrics.TRANSPORT_FAILURES.inc()
                obs_events.emit(
                    "transport_failure",
                    leader=leader,
                    partitions=sorted(lparts),
                    error=f"{type(e).__name__}: {e}",
                )
                return _TransportFailure(leader, list(lparts), e)

        pool: "object | None" = None

        fetch_round = 0
        while remaining:
            now = time.monotonic()
            by_leader: Dict[int, List[int]] = {}
            deferred: "List[float]" = []
            for p in remaining:
                leader = self._leaders[p]
                retry_at = leader_retry_at.get(leader)
                if retry_at is not None and retry_at > now:
                    deferred.append(retry_at)
                    continue
                by_leader.setdefault(leader, []).append(p)
            if not by_leader:
                # Every remaining partition's leader is inside its backoff
                # window: sleep to the earliest retry deadline instead of
                # spinning the loop.
                sleep_s = min(deferred) - time.monotonic()
                if sleep_s > 0:
                    note_backoff_sleep(sleep_s)
                    time.sleep(sleep_s)
                continue
            progressed = False
            fetch_round += 1
            if len(by_leader) > 1 and pool is None:
                from concurrent.futures import ThreadPoolExecutor

                # max_workers is a CAP, not a pre-spawn: the executor
                # creates threads lazily up to the concurrent task count,
                # so leaders discovered later (metadata reload) still get
                # full parallelism without resizing.
                pool = ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="kta-fetch"
                )
                pools.append(pool)
            if pool is not None and len(by_leader) > 1:
                results = list(
                    pool.map(
                        lambda kv: fetch_leader_guarded(kv[0], kv[1], fetch_round),
                        by_leader.items(),
                    )
                )
            else:
                results = [
                    fetch_leader_guarded(leader, lparts, fetch_round)
                    for leader, lparts in by_leader.items()
                ]
            transport_failed = False
            for result in results:
                if isinstance(result, _TransportFailure):
                    transport_failed = True
                    streak = leader_fail_streak.get(result.leader, 0) + 1
                    leader_fail_streak[result.leader] = streak
                    # Capped exponential + jitter, paced per leader.  A
                    # post-reload migration hands the partitions a new
                    # leader id with no pending deadline, so they refetch
                    # immediately.
                    leader_retry_at[result.leader] = (
                        time.monotonic() + backoff.delay_ms(streak) / 1000.0
                    )
                    reason = (
                        f"{type(result.error).__name__}: {result.error}"
                    )
                    for p in result.partitions:
                        if p not in remaining:
                            continue
                        if budget.record_failure(p, reason):
                            degrade(p, budget.degraded[p])
                    continue
                leader, fps, scans, soas, spec_sent, order, pmax_sent = result
                leader_fail_streak.pop(leader, None)
                leader_retry_at.pop(leader, None)
                for fp in fps:
                    p = fp.partition
                    if p not in remaining:
                        continue
                    # A response arrived for this partition: its transport
                    # is alive again (protocol errors are tracked by
                    # error_streak separately).
                    budget.record_success(p)
                    if fp.error:
                        # Warn and re-poll, like the reference's poll loop
                        # (src/kafka.rs:95-97) — but with recovery for the
                        # known-persistent errors and a bounded retry budget.
                        log.warning("fetch error %d on partition %d", fp.error, p)
                        obs_metrics.FETCH_ERRORS.inc()
                        obs_events.emit(
                            "fetch_error", partition=p, code=fp.error
                        )
                        error_streak[p] += 1
                        if fp.error == kc.ERR_NOT_LEADER_FOR_PARTITION:
                            self._reload_metadata()
                        elif fp.error in (
                            kc.ERR_FENCED_LEADER_EPOCH,
                            kc.ERR_UNKNOWN_LEADER_EPOCH,
                        ):
                            # KIP-320 fence: the leader's epoch moved past
                            # the one we tracked (election).  Verify the
                            # cursor against the post-election log before
                            # fetching on.
                            obs_metrics.LOG_EPOCH_FENCES.inc()
                            fenced_epoch = self._epoch_for(p)
                            obs_events.emit(
                                "epoch_fence",
                                partition=p,
                                code=fp.error,
                                epoch=fenced_epoch,
                            )
                            # Unfence first: neither the divergence probe
                            # nor the next fetch may re-fence on the stale
                            # epoch (it re-learns the new one from the
                            # next response's batch headers).
                            self._clear_epoch(p)
                            self._reload_metadata()
                            div = self.check_divergence(
                                p, next_offset[p], fenced_epoch
                            )
                            if div is not None:
                                # The log diverged BELOW the cursor: the
                                # folded prefix [div, cursor) described
                                # batches the election threw away (the
                                # span marks the fold non-authoritative),
                                # and the window tail [cursor, end) no
                                # longer exists to read.  Book the whole
                                # destroyed range and finish the partition
                                # — never rewind the cursor into the
                                # replacement log, which would
                                # double-count offsets [div, cursor).
                                self._note_lost(
                                    p, div, end[p], "truncation"
                                )
                                next_offset[p] = end[p]
                                remaining.discard(p)
                            progressed = True
                        elif fp.error == kc.ERR_OFFSET_OUT_OF_RANGE:
                            # Retention advanced past our offset: account
                            # for the lost range [old_next, new_earliest),
                            # then resume there (window stays [.., end)).
                            try:
                                new_start = self._earliest_offset(p)
                            except (OSError, kc.KafkaProtocolError) as e:
                                # Leader unreachable for the re-anchor
                                # lookup: stay put; the streak/budget
                                # bounds the retries.
                                log.warning(
                                    "re-anchor lookup for partition %d "
                                    "failed: %s", p, e,
                                )
                                new_start = next_offset[p]
                            if new_start > next_offset[p]:
                                self._note_lost(
                                    p, next_offset[p], new_start,
                                    "retention",
                                )
                                next_offset[p] = new_start
                                progressed = True
                            else:
                                # Lookup failed, or the broker answered a
                                # log start at/below our cursor (stale
                                # replica, or out-of-range from the HEAD
                                # side after a truncation).  Clamp
                                # monotone — never rewind — book the
                                # non-advance, and leave the round
                                # non-progressing so the streak/budget
                                # bounds engage deterministically.
                                obs_metrics.LOG_LOST_RANGES.labels(
                                    reason="re-anchor-regressed"
                                ).inc()
                                obs_events.emit(
                                    "re_anchor_regressed",
                                    partition=p,
                                    cursor=next_offset[p],
                                    answered=new_start,
                                )
                        if error_streak[p] >= max_error_streak:
                            degrade(
                                p,
                                f"{error_streak[p]} consecutive fetch "
                                f"errors (last: {fp.error})",
                            )
                        continue
                    error_streak[p] = 0
                    self._observe_log_start(p, fp.log_start_offset)
                    # KIP-320: peek the leading batch header's
                    # partition_leader_epoch (fixed at byte 12 of a v2
                    # frame, independent of the native/python decode
                    # split).  A REGRESSION means this response came from
                    # a pre-election log — verify the cursor before
                    # folding past it.
                    if len(fp.records) >= 17 and fp.records[16] == 2:
                        frame_epoch = struct.unpack_from(
                            ">i", fp.records, 12
                        )[0]
                        if self._observe_epoch(p, frame_epoch):
                            div = self.check_divergence(
                                p, next_offset[p], frame_epoch
                            )
                            if div is not None:
                                self._note_lost(
                                    p, div, next_offset[p], "truncation"
                                )
                    consumed = 0
                    # One past the highest offset COVERED by a complete
                    # frame (batch headers keep last_offset_delta across
                    # compaction, so this advances past removed ranges).
                    max_frame_end = -1
                    data = fp.records
                    pre = soas.get(p)
                    if sink is not None and use_native_decode and data:
                        # Fused fast path: the record set's native prefix
                        # decodes→packs straight into the sink's wire-v4
                        # rows in ONE GIL-released C++ pass — the same
                        # acceptance window and next_offset rule as
                        # accept_records, with no SoA intermediate.  The
                        # remainder (compressed/legacy/truncated/
                        # malformed) takes the per-frame chain below,
                        # entering the same rows via push_chunk.
                        _t_dec = _perf_counter()
                        n_acc, used, covered, last = sink.append_record_set(
                            data, next_offset[p], end[p], p,
                            self.verify_crc, prescan=scans.get(p),
                        )
                        # Fused streams skip the phase-1 pre-decode; their
                        # decode IS this pack, booked on the same counter.
                        obs_metrics.DECODE_SECONDS.inc(
                            _perf_counter() - _t_dec
                        )
                        if used:
                            max_frame_end = max(max_frame_end, covered)
                            if n_acc:
                                next_offset[p] = last + 1
                                consumed += n_acc
                                progressed = True
                            data = data[used:] if used < len(data) else b""
                    elif pre is not None or (use_native_decode and data):
                        # Whole-response fast path: every leading complete
                        # uncompressed v2 frame decoded in ONE native call
                        # (already done in phase 1 for clean prefixes);
                        # only the remainder (compressed/legacy/truncated)
                        # takes the per-frame loop below.
                        if pre is not None:
                            soa, used, covered = pre
                        else:
                            # Lazy whole-response decode (no phase-1
                            # prescan): booked on the same counter as the
                            # pre-decode pass — the doctor's decode
                            # evidence must see this path too.
                            _t_dec = _perf_counter()
                            soa, used, covered = native.decode_record_set_native(
                                data, self.verify_crc, prescan=scans.get(p)
                            )
                            obs_metrics.DECODE_SECONDS.inc(
                                _perf_counter() - _t_dec
                            )
                        if used:
                            max_frame_end = max(max_frame_end, covered)
                            cnt = accept_records(soa, p, "frame-fallback")
                            if cnt:
                                consumed += cnt
                                progressed = True
                            data = data[used:] if used < len(data) else b""
                    if not isinstance(data, (bytes, bytearray)):
                        # The remainder (compressed/legacy/truncated frames)
                        # goes through the per-frame Python decoders, which
                        # expect a real bytes-like (str decode, hashing).
                        data = bytes(data)
                    corrupt_stop = False
                    corrupt_skipped = False
                    #: A poisoned span came before the frame at hand.
                    salvaged = False

                    def book_corruption(
                        err, claimed_end, resume_offset, n_records, raw
                    ) -> bool:
                        """One corrupt-frame sighting for partition ``p``:
                        True to keep salvaging this record set, False to
                        stop the partition's round (the span's identical
                        re-fetch is pending, or the partition degraded).
                        Raises under the ``fail`` policy once the damage
                        proves deterministic."""
                        nonlocal progressed, corrupt_skipped
                        anchor = next_offset[p]
                        skip_to = self._note_corrupt(
                            p, anchor, err, claimed_end, resume_offset,
                            n_records, raw,
                        )
                        if skip_to is None:
                            return False  # disambiguating re-fetch pending
                        if skip_to <= anchor:
                            # No usable skip bound (mangled header at the
                            # response tail): retrying would loop on the
                            # same bytes forever, so drop the partition.
                            degrade(
                                p,
                                "unskippable corrupt frame at offset "
                                f"{anchor} ({err.kind})",
                            )
                            return False
                        next_offset[p] = min(skip_to, end[p])
                        corrupt_skipped = True
                        progressed = True
                        return True

                    for item in kc.salvage_batch_frames(
                        data, verify_crc=self.verify_crc
                    ):
                        if isinstance(item, kc.CorruptSpan):
                            salvaged = True
                            if not book_corruption(
                                item.error,
                                item.claimed_end,
                                item.resume_offset,
                                item.num_records,
                                bytes(data[item.start : item.end]),
                            ):
                                corrupt_stop = True
                                break
                            continue
                        frame = item
                        reason = _fallback_reason(frame, data, salvaged)
                        max_frame_end = max(max_frame_end, frame.end_offset)
                        chunk = (
                            native.decode_records_native(frame)
                            if use_native_decode
                            else None
                        )
                        if chunk is not None:
                            # Keep records in [next_offset, end): compressed
                            # batches can start earlier; records past the
                            # snapshot watermark are out of scope.
                            cnt = accept_records(chunk, p, reason)
                            if cnt:
                                consumed += cnt
                                progressed = True
                            continue
                        # Python fallback (no shim, or malformed frame — the
                        # reference decoder raises the precise error).
                        # Rows commit only after the frame decodes fully, so
                        # a record-body corruption mid-frame cannot leave a
                        # half-accepted frame behind.
                        rows = []
                        row_offs = []
                        frame_next = next_offset[p]
                        try:
                            for off, (ts_ms, key, value) in kc.decode_frame_records(
                                frame
                            ):
                                if off < frame_next:
                                    continue
                                if off >= end[p]:
                                    break
                                rows.append((p, ts_ms, key, value))
                                row_offs.append(off)
                                frame_next = off + 1
                        except kc.CorruptFrameError as ce:
                            salvaged = True
                            raw = (
                                bytes(data[frame.byte_start : frame.byte_end])
                                if frame.byte_start >= 0
                                else b""
                            )
                            if not book_corruption(
                                ce, frame.end_offset, -1,
                                frame.num_records, raw,
                            ):
                                corrupt_stop = True
                                break
                            continue  # poisoned frame's rows are dropped
                        if rows:
                            batch = records_to_batch(
                                rows, use_native=self.use_native_hashing
                            )
                            batch.offsets = np.array(row_offs, dtype=np.int64)
                            push_chunk(
                                batch,
                                "legacy" if reason == "legacy"
                                else "python-decode",
                            )
                            next_offset[p] = frame_next
                            consumed += len(rows)
                            progressed = True
                    if corrupt_stop:
                        # The partition's round ended at a poisoned span:
                        # either its identical re-fetch happens next round,
                        # or the partition just degraded.  Skip the stall/
                        # fetch-size heuristics — they reason about byte
                        # limits, not poison.
                        stall_streak[p] = 0
                        if next_offset[p] >= end[p]:
                            remaining.discard(p)
                        continue
                    if consumed:
                        stall_streak[p] = 0
                        if max_frame_end > next_offset[p]:
                            # The consumed batch's covered range extends
                            # past its last retained record (tail
                            # compaction): advance to the covered end so
                            # the next fetch doesn't re-serve this batch
                            # just to discard it.
                            next_offset[p] = min(max_frame_end, end[p])
                    elif corrupt_skipped:
                        # Poison skipped but nothing accepted this round
                        # (the skipped frame was the only in-range one):
                        # the skip itself is the progress.
                        stall_streak[p] = 0
                        if max_frame_end > next_offset[p]:
                            next_offset[p] = min(max_frame_end, end[p])
                    elif next_offset[p] < end[p]:
                        if max_frame_end > next_offset[p]:
                            # Complete frames cover our fetch position but
                            # every retained record is out of range —
                            # compaction removed the rest of the covered
                            # span.  Batch headers keep last_offset_delta
                            # across compaction, so skip to one past it.
                            next_offset[p] = min(max_frame_end, end[p])
                            stall_streak[p] = 0
                            progressed = True
                        elif len(fp.records) == 0:
                            if p == order[0]:
                                # We led this request, and brokers return
                                # at least one complete batch for the first
                                # partition with data (KIP-74
                                # minOneMessage) — empty is authoritative:
                                # nothing retained in [next_offset, end).
                                next_offset[p] = end[p]
                                progressed = True
                            else:
                                # A non-leading partition can be starved by
                                # siblings (response budget) or by its own
                                # batch exceeding the per-partition limit;
                                # rotation brings it to the front within
                                # len(parts) rounds for the authoritative
                                # answer.
                                stall_streak[p] += 1
                                if stall_streak[p] >= max_stall:
                                    degrade(
                                        p,
                                        f"{stall_streak[p]} consecutive "
                                        "empty fetches",
                                    )
                        else:
                            # Frames present but none complete at/past our
                            # position: the response was truncated by a byte
                            # limit.  If the per-partition limit was binding
                            # (response filled it), grow it; otherwise the
                            # response-level budget cut us short — refetch,
                            # budget frees as other partitions drain.
                            if len(fp.records) >= pmax_sent:
                                if pmax_sent >= MAX_PARTITION_FETCH_BYTES:
                                    degrade(
                                        p,
                                        "cannot decode fetch response even "
                                        "at max.partition.fetch.bytes="
                                        f"{pmax_sent}",
                                    )
                                    continue
                                with self._fetch_grow_lock:
                                    self.partition_max_bytes = min(
                                        max(
                                            self.partition_max_bytes,
                                            pmax_sent * 2,
                                        ),
                                        MAX_PARTITION_FETCH_BYTES,
                                    )
                                log.warning(
                                    "partition %d: batch exceeds fetch size,"
                                    " growing max.partition.fetch.bytes to %d",
                                    p,
                                    self.partition_max_bytes,
                                )
                                stall_streak[p] = 0
                                progressed = True
                            else:
                                stall_streak[p] += 1
                                if stall_streak[p] >= max_stall:
                                    degrade(
                                        p,
                                        f"{stall_streak[p]} consecutive "
                                        "fetches with no progress "
                                        "(truncated responses)",
                                    )
                    if next_offset[p] >= end[p]:
                        remaining.discard(p)
                if spec_sent:
                    fl2 = inflight.get(leader)
                    if fl2 is not None and any(
                        p in remaining and next_offset[p] != off
                        for p, off in fl2[2].items()
                    ):
                        # Speculation missed (compressed tail, error,
                        # truncation): drain and discard so the next round
                        # fetches from the authoritative offsets.
                        inflight.pop(leader, None)
                        try:
                            fl2[0].read_response(fl2[1])
                        except Exception:
                            fl2[0].close()
                            with conn_lock:
                                if own_conns.get(leader) is fl2[0]:
                                    own_conns.pop(leader, None)
                yield from flush(force=False)
            if transport_failed and remaining:
                # Dead/reset connections this round: refresh the topology
                # (a restarted broker or migrated leader shows up in fresh
                # metadata; partitions re-route via by_leader next round,
                # reconnection happens lazily in own_conn).  Retry pacing
                # is the failed leader's per-leader deadline above — the
                # healthy leaders keep streaming unthrottled.
                self._reload_metadata()
            elif not progressed and remaining:
                # Nothing moved this round (e.g. leader churn): brief
                # pause so error responses don't busy-spin the broker.
                time.sleep(self.error_backoff_ms / 1000.0)
        yield from flush(force=True)


def _fallback_reason(frame: kc.BatchFrame, data: bytes, salvaged: bool) -> str:
    """Why a frame's records reach a fused sink as a decoded batch, not
    through the one-pass decode→pack (`packing.FusedPackSink.fallbacks`):
    a legacy message set, a frame after a poisoned span, a compressed
    frame (the codec in the low three bits of the v2 attributes, bytes
    21-22 of the frame), or any other frame past the native prefix.  A
    v2 frame that only the Python decoder takes is booked
    ``python-decode`` instead (`packing.FALLBACK_LABEL`)."""
    if frame.legacy_records is not None:
        return "legacy"
    if salvaged:
        return "salvaged"
    if frame.byte_start >= 0 and data[frame.byte_start + 22] & 0x07:
        return "compressed"
    return "frame-fallback"


def _chunk_to_batch(
    chunk: "dict[str, np.ndarray]", sel, partition: int
) -> RecordBatch:
    """Native-decoded SoA frame (io/native.py::decode_records_native) →
    RecordBatch for the selected records.

    ``sel`` is a slice (the hot path: in-range records are a contiguous run
    because offsets increase within a record set — columns become zero-copy
    VIEWS of the freshly-allocated SoA buffers) or an index array (the
    fallback when a broker violates the ordering contract).  Bool columns
    are reinterpreted with ``.view``, not ``astype`` — the decoder writes
    0/1 uint8."""
    offs = chunk["offsets"][sel]
    n = len(offs)
    ts_ms = chunk["ts_ms"][sel]
    if isinstance(sel, slice):
        ts_ms = ts_ms.copy()  # about to clamp in place; don't mutate the SoA
    # Missing timestamps (-1) report as 0 ms (``to_millis().unwrap_or(0)``,
    # src/metric.rs:209) — matching records_to_batch.
    np.maximum(ts_ms, 0, out=ts_ms)
    batch = RecordBatch(
        partition=np.full(n, partition, dtype=np.int32),
        key_len=chunk["key_len"][sel],
        value_len=chunk["value_len"][sel],
        key_null=chunk["key_null"][sel].view(np.bool_),
        value_null=chunk["value_null"][sel].view(np.bool_),
        ts_s=ts_ms // 1000,
        key_hash32=chunk["key_hash32"][sel],
        key_hash64=chunk["key_hash64"][sel],
        valid=np.ones(n, dtype=np.bool_),
    )
    batch.offsets = offs
    return batch


def records_to_batch(
    rows: List[Tuple[int, int, Optional[bytes], Optional[bytes]]],
    use_native: bool = True,
) -> RecordBatch:
    """(partition, ts_ms, key, value) rows → RecordBatch with hashes."""
    n = len(rows)
    partition = np.fromiter((r[0] for r in rows), dtype=np.int32, count=n)
    ts_ms = np.fromiter(
        # Missing timestamps (-1) report as 0 ms, like
        # ``to_millis().unwrap_or(0)`` (src/metric.rs:209).
        ((r[1] if r[1] >= 0 else 0) for r in rows),
        dtype=np.int64,
        count=n,
    )
    keys = [r[2] for r in rows]
    values = [r[3] for r in rows]
    key_null = np.fromiter((k is None for k in keys), dtype=np.bool_, count=n)
    value_null = np.fromiter((v is None for v in values), dtype=np.bool_, count=n)
    key_len = np.fromiter(
        (len(k) if k is not None else 0 for k in keys), dtype=np.int32, count=n
    )
    value_len = np.fromiter(
        (len(v) if v is not None else 0 for v in values), dtype=np.int32, count=n
    )
    h32, h64 = _hash_keys(keys, use_native=use_native)
    h32 = np.where(key_null, np.uint32(0), h32)
    h64 = np.where(key_null, np.uint64(0), h64)
    # Truncate toward zero like Rust integer division (src/metric.rs:210).
    ts_s = (np.abs(ts_ms) // 1000) * np.sign(ts_ms)
    return RecordBatch(
        partition=partition,
        key_len=key_len,
        value_len=value_len,
        key_null=key_null,
        value_null=value_null,
        ts_s=ts_s,
        key_hash32=h32,
        key_hash64=h64,
        valid=np.ones(n, dtype=np.bool_),
    )
