"""The port's counterpart of ``tests/test_k8s_rest.py`` (``tpu_nexus_torch``).

RestKubeClient tests against a loopback fake API server (aiohttp)."""

import asyncio
import json

import pytest
from aiohttp import web

from tpu_nexus_torch.k8s.client import NotFoundError
from tpu_nexus_torch.k8s.rest import RestKubeClient


def make_app(state):
    app = web.Application()

    async def list_pods(request):
        state["list_headers"] = dict(request.headers)
        if request.query.get("watch") == "1":
            state["watch_rv"] = request.query.get("resourceVersion")
            resp = web.StreamResponse()
            resp.content_type = "application/json"
            await resp.prepare(request)
            if "watch_script" in state:  # one scripted event list per call
                n = state.setdefault("watch_calls", 0)
                state["watch_calls"] = n + 1
                script = state["watch_script"]
                events = script[min(n, len(script) - 1)]
                for evt in events:
                    await resp.write((json.dumps(evt) + "\n").encode())
                # keep an empty (idle) stream open so the informer parks on
                # it instead of spinning through relists
                await asyncio.sleep(5 if not events else 0.05)
                return resp
            if "watch_raw_writes" in state:  # byte-exact frame segmentation
                for blob in state["watch_raw_writes"]:
                    await resp.write(blob)
                    await asyncio.sleep(0.01)  # force separate reads
                await asyncio.sleep(0.05)
                return resp
            for evt in state.get("watch_events", []):
                await resp.write((json.dumps(evt) + "\n").encode())
            # hold the stream open briefly, then end (client iterates out)
            await asyncio.sleep(0.05)
            return resp
        if "lists" in state:  # scripted list-per-call
            n = state.setdefault("list_calls", 0)
            state["list_calls"] = n + 1
            return web.json_response(state["lists"][min(n, len(state["lists"]) - 1)])
        return web.json_response(
            {
                "kind": "PodList",
                "metadata": {"resourceVersion": "42"},
                "items": [{"metadata": {"name": "p1", "namespace": "nexus"}}],
            }
        )

    async def delete_job(request):
        state["delete_body"] = await request.json()
        name = request.match_info["name"]
        if name == "missing":
            return web.json_response({"kind": "Status", "code": 404}, status=404)
        return web.json_response({"kind": "Status", "status": "Success"})

    async def create_job(request):
        state["created"] = await request.json()
        return web.json_response(state["created"])

    app.router.add_get("/api/v1/namespaces/nexus/pods", list_pods)
    app.router.add_delete("/apis/batch/v1/namespaces/nexus/jobs/{name}", delete_job)
    app.router.add_post("/apis/batch/v1/namespaces/nexus/jobs", create_job)
    return app


@pytest.fixture
def state():
    return {}


async def run_with_server(state, fn):
    app = make_app(state)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    client = RestKubeClient(f"http://127.0.0.1:{port}", token="sekret")
    try:
        await fn(client)
    finally:
        await client.close()
        await runner.cleanup()


async def test_list_objects_and_auth_header(state):
    async def fn(client):
        items, rv = await client.list_objects("Pod", "nexus")
        assert rv == "42"
        assert items[0]["metadata"]["name"] == "p1"
        assert items[0]["kind"] == "Pod"  # kind restored for typed views
        assert state["list_headers"]["Authorization"] == "Bearer sekret"

    await run_with_server(state, fn)


async def test_watch_streams_chunked_lines(state):
    state["watch_events"] = [
        {"type": "ADDED", "object": {"metadata": {"name": "p2", "namespace": "nexus"}}},
        {"type": "BOOKMARK", "object": {"metadata": {"resourceVersion": "50"}}},
        {"type": "DELETED", "object": {"metadata": {"name": "p2", "namespace": "nexus"}}},
    ]

    async def fn(client):
        seen = []
        async for event_type, obj in client.watch_objects("Pod", "nexus", "42"):
            seen.append((event_type, obj["metadata"].get("name")))
        assert state["watch_rv"] == "42"
        assert ("ADDED", "p2") in seen and ("DELETED", "p2") in seen

    await run_with_server(state, fn)


async def test_delete_job_background_propagation(state):
    async def fn(client):
        await client.delete_job("nexus", "run-1")
        assert state["delete_body"]["propagationPolicy"] == "Background"
        with pytest.raises(NotFoundError):
            await client.delete_object("Job", "nexus", "missing")

    await run_with_server(state, fn)


async def test_create_object(state):
    async def fn(client):
        out = await client.create_object("Job", "nexus", {"metadata": {"name": "j1"}})
        assert out["metadata"]["name"] == "j1"

    await run_with_server(state, fn)


async def test_watch_reassembles_frames_split_across_reads(state):
    """Watch frames arrive however TCP segments them — a JSON line split
    mid-object across writes, and two events coalesced into one write, must
    decode identically ('chunked frames split across reads' is exactly
    where hand-rolled clients die)."""
    e1 = json.dumps({"type": "ADDED", "object": {"metadata": {"name": "px", "namespace": "nexus"}}}) + "\n"
    e2 = json.dumps({"type": "MODIFIED", "object": {"metadata": {"name": "px", "namespace": "nexus"}}}) + "\n"
    e3 = json.dumps({"type": "DELETED", "object": {"metadata": {"name": "px", "namespace": "nexus"}}}) + "\n"
    # split e1 mid-JSON; coalesce the tail of e1 with ALL of e2 and half of
    # e3; finish e3 — no write boundary coincides with a frame boundary
    state["watch_raw_writes"] = [
        e1[:7].encode(),
        e1[7:].encode() + e2.encode() + e3[:11].encode(),
        e3[11:].encode(),
    ]

    async def fn(client):
        seen = [et async for et, _ in client.watch_objects("Pod", "nexus", "42")]
        assert seen == ["ADDED", "MODIFIED", "DELETED"]

    await run_with_server(state, fn)


async def test_watch_410_error_event_raises(state):
    """A mid-stream ERROR frame (410 Gone: resourceVersion too old) must
    surface as KubeClientError — the informer's relist path depends on it."""
    from tpu_nexus_torch.k8s.client import KubeClientError

    state["watch_events"] = [
        {"type": "ADDED", "object": {"metadata": {"name": "p9", "namespace": "nexus"}}},
        {
            "type": "ERROR",
            "object": {
                "kind": "Status", "code": 410,
                "reason": "Expired", "message": "too old resource version: 42 (99)",
            },
        },
    ]

    async def fn(client):
        seen = []
        with pytest.raises(KubeClientError, match="too old resource version"):
            async for et, obj in client.watch_objects("Pod", "nexus", "42"):
                seen.append(et)
        assert seen == ["ADDED"]  # events before the error were delivered

    await run_with_server(state, fn)


async def test_informer_relists_and_diffs_after_410(state):
    """Full informer loop over real HTTP: initial LIST+watch, a 410 Gone
    mid-stream, then a re-LIST whose diff must deliver what changed during
    the outage (ADDED for new, DELETED for gone) — the client-go contract
    the reference gets for free (services/supervisor.go:71-75)."""
    from datetime import timedelta

    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.k8s.informer import Informer

    pod = lambda n: {"metadata": {"name": n, "namespace": "nexus"}}  # noqa: E731
    # phase 0: LIST [a, b]; watch delivers ADDED c then 410.
    # phase 1: LIST [a, c, d] (b vanished, d appeared during the outage);
    #          watch idles (empty) so the informer parks on the stream.
    state["lists"] = [
        {"kind": "PodList", "metadata": {"resourceVersion": "10"}, "items": [pod("a"), pod("b")]},
        {"kind": "PodList", "metadata": {"resourceVersion": "20"}, "items": [pod("a"), pod("c"), pod("d")]},
    ]
    state["watch_script"] = [
        [
            {"type": "ADDED", "object": pod("c")},
            {"type": "ERROR", "object": {"kind": "Status", "code": 410, "message": "too old resource version"}},
        ],
        [],
    ]

    async def fn(client):
        informer = Informer(client, "Pod", "nexus", resync_period=timedelta(0))
        events = []
        informer.add_event_handler(lambda et, obj: events.append((et, obj.meta.name)))
        ctx = LifecycleContext()
        task = asyncio.create_task(informer.run(ctx))
        deadline = asyncio.get_running_loop().time() + 10
        want = {("ADDED", "a"), ("ADDED", "b"), ("ADDED", "c"), ("DELETED", "b"), ("ADDED", "d")}
        while asyncio.get_running_loop().time() < deadline and not want <= set(events):
            await asyncio.sleep(0.02)
        ctx.cancel()
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        assert want <= set(events), events
        # cache repaired to the post-outage truth
        assert {o.meta.name for o in informer.items()} == {"a", "c", "d"}

    await run_with_server(state, fn)


def test_kubeconfig_parsing(tmp_path):
    kc = tmp_path / "config"
    kc.write_text(
        """
apiVersion: v1
kind: Config
current-context: ctx
contexts:
- name: ctx
  context: {cluster: c1, user: u1}
clusters:
- name: c1
  cluster: {server: "http://127.0.0.1:6443"}
users:
- name: u1
  user: {token: "tok"}
"""
    )
    client = RestKubeClient.from_kubeconfig(str(kc))
    assert client.base_url == "http://127.0.0.1:6443"
    assert client._headers()["Authorization"] == "Bearer tok"
