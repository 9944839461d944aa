"""The port's counterpart of ``tests/test_apiserver_integration.py`` (``tpu_nexus_torch``).

RestKubeClient + SharedInformerFactory against a REAL kube-apiserver.

The hand-rolled LIST/WATCH/resourceVersion
plane (k8s/rest.py, k8s/informer.py) had only ever met an aiohttp loopback
stub; the reference gets the apiserver contract for free from client-go
(services/supervisor.go:16-18,71-75).  This suite drives the real contract:
list -> watch -> event delivery -> delete (background propagation) -> watch
DELETED -> informer relist repair, against envtest-style control-plane
binaries (`etcd` + `kube-apiserver`).

Gating mirrors the real-Scylla suite: the tests SKIP with a reason unless
the binaries are found (KUBEBUILDER_ASSETS — `setup-envtest use -p path` —
or $PATH), and NEXUS_REQUIRE_APISERVER=1 turns a skip into a failure so CI
runners that provision the binaries cannot silently lose the coverage.
410-Gone mid-stream and split-frame decoding are deterministic against the
protocol stub in test_k8s_rest.py; here the same informer loop runs against
the genuine apiserver implementation (chunked frames, bookmarks, real
resourceVersion discipline).
"""

import asyncio
import json
import os
import shutil
import socket
import subprocess
import time

import pytest

KUBE_ASSETS = os.environ.get("KUBEBUILDER_ASSETS", "")


def _find(binary: str):
    if KUBE_ASSETS:
        cand = os.path.join(KUBE_ASSETS, binary)
        if os.path.exists(cand):
            return cand
    return shutil.which(binary)


ETCD = _find("etcd")
APISERVER = _find("kube-apiserver")
HAVE_BINARIES = bool(ETCD and APISERVER)

if os.environ.get("NEXUS_REQUIRE_APISERVER") == "1" and not HAVE_BINARIES:
    pytest.fail(
        "NEXUS_REQUIRE_APISERVER=1 but etcd/kube-apiserver binaries not found "
        "(set KUBEBUILDER_ASSETS, e.g. via `setup-envtest use -p path`)",
        pytrace=False,
    )

pytestmark = pytest.mark.skipif(
    not HAVE_BINARIES,
    reason="etcd + kube-apiserver binaries not available "
    "(install envtest binaries and set KUBEBUILDER_ASSETS to enable)",
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


TOKEN = "nexus-apiserver-test-token"


@pytest.fixture(scope="module")
def apiserver(tmp_path_factory):
    """etcd + kube-apiserver with static-token auth, torn down after the
    module.  Yields the https base URL."""
    root = tmp_path_factory.mktemp("apiserver")
    etcd_port, etcd_peer = _free_port(), _free_port()
    api_port = _free_port()

    procs = []

    def _teardown():
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)

    try:
        procs.append(subprocess.Popen(
            [
                ETCD,
                "--data-dir", str(root / "etcd"),
                "--listen-client-urls", f"http://127.0.0.1:{etcd_port}",
                "--advertise-client-urls", f"http://127.0.0.1:{etcd_port}",
                "--listen-peer-urls", f"http://127.0.0.1:{etcd_peer}",
            ],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        ))

        sa_key = root / "sa.key"
        subprocess.run(
            ["openssl", "genrsa", "-out", str(sa_key), "2048"],
            check=True, capture_output=True,
        )
        tokens = root / "tokens.csv"
        tokens.write_text(f"{TOKEN},nexus-admin,nexus-admin-uid,system:masters\n")

        procs.append(subprocess.Popen(
            [
                APISERVER,
                "--etcd-servers", f"http://127.0.0.1:{etcd_port}",
                "--secure-port", str(api_port),
                "--cert-dir", str(root / "certs"),  # self-signed serving certs
                "--token-auth-file", str(tokens),
                "--authorization-mode", "AlwaysAllow",
                "--service-account-issuer", "https://kubernetes.default.svc",
                "--service-account-signing-key-file", str(sa_key),
                "--service-account-key-file", str(sa_key),
                "--disable-admission-plugins", "ServiceAccount",
                "--watch-cache=true",
            ],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        ))

        base = f"https://127.0.0.1:{api_port}"
        _wait_ready(base, timeout=60)
        yield base
    finally:
        _teardown()


def _wait_ready(base: str, timeout: float) -> None:
    import ssl
    import urllib.request

    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            req = urllib.request.Request(
                f"{base}/readyz", headers={"Authorization": f"Bearer {TOKEN}"}
            )
            with urllib.request.urlopen(req, context=ctx, timeout=2) as resp:
                if resp.status == 200:
                    return
        except Exception as exc:  # noqa: BLE001 - retry until deadline
            last = exc
        time.sleep(0.5)
    raise RuntimeError(f"kube-apiserver not ready in {timeout}s: {last!r}")


def _client(base: str):
    import ssl

    from tpu_nexus_torch.k8s.rest import RestKubeClient

    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE  # self-signed serving cert
    return RestKubeClient(base, token=TOKEN, ssl_context=ctx)


def _job(name: str, ns: str = "default"):
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name, "namespace": ns},
        "spec": {
            "template": {
                "metadata": {"labels": {"job-name": name}},
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [{"name": "main", "image": "busybox", "command": ["true"]}],
                },
            },
        },
    }


async def _drive_list_watch_delete(base: str):
    client = _client(base)
    try:
        items, rv = await client.list_objects("Job", "default")
        assert rv, "LIST must return a resourceVersion"
        baseline = {i["metadata"]["name"] for i in items}

        seen = asyncio.Queue()

        async def watcher():
            async for et, obj in client.watch_objects("Job", "default", rv):
                if et == "BOOKMARK":
                    continue
                await seen.put((et, obj["metadata"]["name"]))

        wtask = asyncio.create_task(watcher())
        try:
            await client.create_object("Job", "default", _job("nexus-it-1"))
            et, name = await asyncio.wait_for(seen.get(), timeout=30)
            assert (et, name) == ("ADDED", "nexus-it-1")
            assert "nexus-it-1" not in baseline

            await client.delete_object("Job", "default", "nexus-it-1")
            # background propagation: DELETED arrives once finalizers clear
            deadline = asyncio.get_running_loop().time() + 30
            got_delete = False
            while asyncio.get_running_loop().time() < deadline:
                et, name = await asyncio.wait_for(seen.get(), timeout=30)
                if name == "nexus-it-1" and et == "DELETED":
                    got_delete = True
                    break
            assert got_delete, "watch must deliver DELETED for the removed Job"
        finally:
            wtask.cancel()
            try:
                await wtask
            except asyncio.CancelledError:
                pass
    finally:
        await client.close()


def test_list_watch_create_delete_roundtrip(apiserver):
    """The supervisor's exact I/O pattern against the real server: LIST with
    rv, WATCH from rv (chunked frames from the real apiserver), CREATE seen
    as ADDED, DELETE (background propagation) seen as DELETED."""
    asyncio.run(_drive_list_watch_delete(apiserver))


async def _drive_informer(base: str):
    from datetime import timedelta

    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.k8s.informer import SharedInformerFactory

    client = _client(base)
    try:
        await client.create_object("Job", "default", _job("nexus-it-pre"))
        factory = SharedInformerFactory(
            client, "default", resync_period=timedelta(seconds=2)
        )
        informer = factory.informer_for("Job")
        events = []
        informer.add_event_handler(lambda et, obj: events.append((et, obj.meta.name)))
        ctx = LifecycleContext()
        factory.start(ctx)
        assert await factory.wait_for_cache_sync(timeout=30)
        assert informer.get("nexus-it-pre") is not None  # initial LIST seeded

        await client.create_object("Job", "default", _job("nexus-it-live"))
        deadline = asyncio.get_running_loop().time() + 30
        while asyncio.get_running_loop().time() < deadline:
            if ("ADDED", "nexus-it-live") in events and informer.get("nexus-it-live"):
                break
            await asyncio.sleep(0.05)
        assert ("ADDED", "nexus-it-live") in events, events

        # survive at least one resync relist (period 2s) without phantom
        # ADDED/DELETED churn for unchanged objects
        n_before = len([e for e in events if e[1] == "nexus-it-pre"])
        await asyncio.sleep(3)
        n_after = len([e for e in events if e[1] == "nexus-it-pre"])
        assert n_after == n_before, "resync relist must not re-deliver unchanged objects"

        ctx.cancel()
        await factory.shutdown()
        for name in ("nexus-it-pre", "nexus-it-live"):
            await client.delete_object("Job", "default", name)
    finally:
        await client.close()


def test_informer_against_real_apiserver(apiserver):
    """SharedInformerFactory end to end on the real watch stream: cache
    seeding, live event delivery, and resync relists that stay quiet for
    unchanged objects."""
    asyncio.run(_drive_informer(apiserver))
