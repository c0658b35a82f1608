"""Faults of a Kafka scan: the port CLI and the reference CLI side by side
over the loopback `fake_broker` brokers.

Poisoned frames under ``--on-corruption fail|skip|quarantine`` (same exit
code, error line or CORRUPT block, and quarantined files); a log that
moves under the scan (retention, truncation, an unclean election) under
``--on-data-loss fail|report|ignore`` (same exit code, error line or
DATA-LOSS block); a partition whose transport retry budget runs out
(exit 3 and the DEGRADED block); SASL PLAIN and SCRAM logins and TLS (the
same report, and the same refusal of a bad password).  A scan aborted by
a corrupt frame returns within a few seconds and leaves no thread of its
own and no socket open.  The port runs ``--backend cpu``, the reference
``--backend tpu`` (JAX on the CPU); reports are compared byte for byte,
timing lines aside.
"""

import os
import re
import ssl
import subprocess
import threading
import time

import pytest

from fake_broker import CorruptionInjector, FakeBroker, FakeCluster, FaultInjector
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.io import kafka_codec as ref_kc
from kafka_topic_analyzer_tpu_torch import cli

TOPIC = "faults.t"
FAST = "retry.backoff.ms=5,reconnect.backoff.max.ms=40"
FLAGS = ["-c", "--alive-bitmap-bits", "24", "--distinct-keys-per-partition",
         "--quantiles-per-partition", "--pallas", "--batch-size", "1024"]


def rows(partition: int, n: int):
    """Keys distinct across partitions (no cross-partition alive slot)."""
    return [(i, 1_600_000_000_000 + i * 1000,
             f"k{partition}-{i % 37}".encode() if i % 5 else None,
             bytes(20 + (i % 13)) if i % 7 else None) for i in range(n)]


def drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


def both(argv, capsys, native_flag: str = "on", port_extra=(), ref_extra=()):
    """(rc, stdout, stderr) of the port CLI and of the reference CLI."""
    out = []
    for main, extra in ((cli.main, ["--backend", "cpu", "--native", native_flag, *port_extra]),
                        (ref_cli.main, ["--backend", "tpu", "--quiet", "--native",
                                        native_flag, *ref_extra])):
        rc = main(argv + extra)
        cap = capsys.readouterr()
        out.append((rc, drop_timing(cap.out), cap.err))
    return out


# -- corruption ---------------------------------------------------------------

CHUNK = 50


def poisoned_broker():
    inj = (CorruptionInjector()
           .flip_byte(0, chunk=2, offset=-1)     # crc-mismatch
           .garbage_compression(0, chunk=4)      # bad-compression
           .flip_byte(1, chunk=1, offset=-3))    # crc-mismatch
    return FakeBroker(TOPIC, {p: rows(p, 300) for p in range(2)},
                      max_records_per_fetch=CHUNK, corruption=inj,
                      honor_partition_max_bytes=True)


def spool(directory: str) -> "dict[str, bytes]":
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("native_flag", ["on", "off"])
@pytest.mark.parametrize("policy", ["fail", "skip", "quarantine"])
def test_on_corruption_policies_match_the_reference(policy, native_flag, tmp_path, capsys):
    with poisoned_broker() as broker:
        argv = ["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", *FLAGS, "--check-crcs",
                "--librdkafka", FAST, "--on-corruption", policy]
        port_q, ref_q = str(tmp_path / "port"), str(tmp_path / "ref")
        extra = (["--quarantine-dir", port_q], ["--quarantine-dir", ref_q]) \
            if policy == "quarantine" else ((), ())
        (rc, out, err), (ref_rc, ref_out, ref_err) = both(
            argv, capsys, native_flag, *extra)
    assert (rc, out, err) == (ref_rc, ref_out, ref_err)
    if policy == "fail":
        assert rc == 1 and out.count("\n") <= 2 and err.startswith("error: ")
        return
    assert rc == cli.EXIT_CORRUPT == 4
    assert "CORRUPT: 3 unreadable frame(s) across 2 partition(s)" in out
    assert "[bad-compression x1, crc-mismatch x1]" in out
    if policy == "quarantine":
        got, want = spool(port_q), spool(ref_q)
        assert len(got) == 6 and got == want
        assert f"{TOPIC}.p0.o100.json" in got and f"{TOPIC}.p0.o100.frame.bin" in got


def test_fused_scan_counts_salvaged_frames(capsys):
    with poisoned_broker() as broker:
        argv = ["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", *FLAGS, "--check-crcs",
                "--librdkafka", FAST, "--on-corruption", "skip", "--backend", "cpu"]
        rc, result = cli.run(cli.build_parser().parse_args(argv + ["--native", "on"]))
        assert rc == 4 and result.fused
        assert result.records == 600 - 3 * CHUNK
        assert set(result.fallbacks) <= {"salvaged", "frame-fallback"}
        assert sum(result.fallbacks.values()) > 0
        rc, chained = cli.run(cli.build_parser().parse_args(argv + ["--native", "off"]))
        assert rc == 4 and not chained.fused and chained.fallbacks == {}
    capsys.readouterr()


# -- data loss ---------------------------------------------------------------

class FetchHook:
    """A broker ``response_delay`` that runs ``action`` once, right after
    the broker encodes its ``fire_at``-th fetch response."""

    def __init__(self, fire_at: int, action):
        self.fire_at, self.action, self.fetches = fire_at, action, 0

    def __call__(self, api_key: int, node_id: int) -> float:
        if api_key == ref_kc.API_FETCH:
            self.fetches += 1
            if self.fetches == self.fire_at:
                self.action()
        return 0.0


#: The mutation after the third fetch (the cursor is at 150).  A bare
#: truncation below the cursor, with no new leader epoch to probe, answers
#: every later fetch OFFSET_OUT_OF_RANGE: the partition degrades (exit 3,
#: whatever the policy), in the reference as in the port.
MUTATIONS = {
    "retention": lambda b: b.expire_to(0, 200),
    "truncation": lambda b: b.truncate_to(0, 120),
    "unclean-election": lambda b: b.unclean_elect(0, truncate_to=100),
}


@pytest.mark.parametrize("policy", ["fail", "report", "ignore"])
@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_on_data_loss_policies_match_the_reference(mutation, policy, capsys):
    results = []
    for main, extra in ((cli.main, ["--backend", "cpu"]),
                        (ref_cli.main, ["--backend", "tpu", "--quiet", "--native", "on"])):
        with FakeBroker(TOPIC, {0: rows(0, 400)}, max_records_per_fetch=50,
                        modern=mutation == "unclean-election") as broker:
            broker.response_delay = FetchHook(3, lambda: MUTATIONS[mutation](broker))
            rc = main(["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", *FLAGS,
                       "--librdkafka", FAST + ",fetch.error.backoff.ms=1",
                       "--on-data-loss", policy] + extra)
        cap = capsys.readouterr()
        results.append((rc, drop_timing(cap.out), cap.err))
    assert results[0] == results[1]
    rc, out, err = results[0]
    if mutation == "truncation":
        assert rc == 3 and "DEGRADED" in out and "DATA-LOSS" not in out
        return
    assert rc == {"fail": 5, "report": 0, "ignore": 0}[policy]
    if policy == "fail":
        assert err.startswith("error: DATA-LOSS: ") and out.count("\n") <= 2
    else:
        assert ("DATA-LOSS:" in out) == (policy == "report")


# -- degraded partitions -----------------------------------------------------

def test_exhausted_retry_budget_degrades_with_exit_3(capsys):
    results = []
    for main, extra in ((cli.main, ["--backend", "cpu"]),
                        (ref_cli.main, ["--backend", "tpu", "--quiet", "--native", "on"])):
        armed = []

        def kill_node_1_on_first_fetch(api_key: int, node_id: int) -> float:
            if api_key == ref_kc.API_FETCH and node_id == 1 and not armed:
                armed.append(True)
                cluster.nodes[1].faults = (FaultInjector()
                                           .drop_connection(0, times=10**6)
                                           .refuse_connections(times=10**6))
            return 0.0

        with FakeCluster(TOPIC, {p: rows(p, 300) for p in range(3)}, n_nodes=2,
                         max_records_per_fetch=100,
                         response_delay=kill_node_1_on_first_fetch) as cluster:
            rc = main(["-t", TOPIC, "-b", cluster.bootstrap, *FLAGS, "--librdkafka",
                       FAST + ",transport.retry.budget=3,socket.timeout.ms=500"] + extra)
        cap = capsys.readouterr()
        results.append((rc, drop_timing(cap.out), cap.err))
    # The reason names the dead broker's port, which differs between the
    # two clusters.
    assert [(rc, re.sub(r"127\.0\.0\.1:\d+", "HOST:PORT", out))
            for rc, out, _ in results[:1]] == \
        [(rc, re.sub(r"127\.0\.0\.1:\d+", "HOST:PORT", out)) for rc, out, _ in results[1:]]
    rc, out, _ = results[0]
    assert rc == cli.EXIT_DEGRADED == 3
    assert "WARNING: 1 partition(s) DEGRADED" in out and "  partition 1: " in out


# -- authentication and TLS --------------------------------------------------

SASL = "security.protocol=sasl_plaintext,sasl.username=scout,sasl.password=hunter2"


@pytest.mark.parametrize("mechanism", ["PLAIN", "SCRAM-SHA-256", "SCRAM-SHA-512"])
def test_sasl_logins_scan_as_the_reference(mechanism, capsys):
    kw = (dict(sasl_plain=("scout", "hunter2")) if mechanism == "PLAIN"
          else dict(sasl_scram=(mechanism, "scout", "hunter2")))
    with FakeBroker(TOPIC, {0: rows(0, 200)}, **kw) as broker:
        argv = ["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", *FLAGS, "--librdkafka",
                f"{FAST},{SASL},sasl.mechanism={mechanism}"]
        (rc, out, _), (ref_rc, ref_out, _) = both(argv, capsys)
        assert rc == ref_rc == 0 and out == ref_out and "Alive keys:" in out
        bad = argv[:-1] + [argv[-1].replace("hunter2", "wrong")]
        (rc, out, err), (ref_rc, ref_out, ref_err) = both(bad, capsys)
    assert (rc, err) == (ref_rc, ref_err)
    assert rc == 1 and err.startswith("error: ")


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    key, cert = d / "key.pem", d / "cert.pem"
    try:
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", str(key),
             "-out", str(cert), "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1",
             "-addext", "subjectAltName=IP:127.0.0.1"],
            check=True, capture_output=True, timeout=60,
        )
    except (OSError, subprocess.CalledProcessError):
        pytest.skip("openssl CLI unavailable")
    return str(key), str(cert)


def test_tls_scan_matches_the_reference(certs, capsys):
    key, cert = certs
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    with FakeBroker(TOPIC, {0: rows(0, 200), 1: rows(1, 90)}, tls_context=ctx) as broker:
        argv = ["-t", TOPIC, "-b", f"127.0.0.1:{broker.port}", *FLAGS, "--librdkafka",
                f"{FAST},security.protocol=ssl,ssl.ca.location={cert}"]
        (rc, out, _), (ref_rc, ref_out, _) = both(argv, capsys)
        assert rc == ref_rc == 0 and out == ref_out
        # Without the CA the certificate is refused, in both.
        untrusted = argv[:-1] + [f"{FAST},security.protocol=ssl"]
        (rc, _, err), (ref_rc, _, ref_err) = both(untrusted, capsys)
    assert rc == ref_rc == 1 and err.startswith("error: ") and ref_err.startswith("error: ")


# -- a prompt and clean abort ------------------------------------------------

def port_threads() -> "set[threading.Thread]":
    """Live threads that are not the fake brokers' (prefetch worker, fetch
    pools)."""
    return {t for t in threading.enumerate()
            if t is not threading.main_thread()
            and "_accept_loop" not in repr(t) and "_handshake_and_serve" not in repr(t)}


def test_corrupt_frame_abort_is_prompt_and_leaves_nothing_behind(capsys):
    """``--on-corruption fail`` on a three-leader topic whose other leaders
    keep answering: the CLI returns 1 in under 5 s (the default socket
    timeout is 10 s) with the fetch pool drained and every socket closed."""
    inj = CorruptionInjector().flip_byte(1, chunk=3, offset=-1)
    recs = {p: rows(p, 2000) for p in range(6)}
    before = port_threads()
    with FakeCluster(TOPIC, recs, n_nodes=3, max_records_per_fetch=CHUNK,
                     corruption=inj, honor_partition_max_bytes=True) as cluster:
        for native_flag in ("on", "off"):
            t0 = time.monotonic()
            rc = cli.main(["-t", TOPIC, "-b", cluster.bootstrap, *FLAGS, "--check-crcs",
                           "--native", native_flag, "--backend", "cpu"])
            secs = time.monotonic() - t0
            assert rc == 1 and secs < 5.0, (native_flag, secs)
            err = capsys.readouterr().err
            assert err.startswith("error: ") and "crc" in err.lower()
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline and (
                    port_threads() - before
                    or any(node._open_conns for node in cluster.nodes)):
                time.sleep(0.02)
            assert not port_threads() - before, port_threads() - before
            assert not any(node._open_conns for node in cluster.nodes)
