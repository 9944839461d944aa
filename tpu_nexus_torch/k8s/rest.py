"""REST Kubernetes client (aiohttp): a copy of ``tpu_nexus/k8s/rest.py``
with ``yaml`` and ``aiohttp`` imported where they are used.

Equivalent of the reference's client-go clientset construction
(app/app_dependencies.go:36-53): kubeconfig-path when configured, else
in-cluster service-account credentials.  Implements the KubeClient surface
the informers and supervisor consume (SURVEY.md §2.4): namespaced LIST,
streaming WATCH (chunked JSON lines), CREATE, and DELETE with propagation
policy.

Construction is lazy: no network I/O (and no aiohttp session) until the
first call, so building a client without a reachable API server is safe —
the same lazy contract the CQL store follows.
"""

from __future__ import annotations

import json
import os
import ssl
import tempfile
from base64 import b64decode
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from tpu_nexus_torch.k8s.client import (
    KIND_API,
    PROPAGATION_BACKGROUND,
    KubeClient,
    KubeClientError,
    NotFoundError,
)

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class RestKubeClient(KubeClient):
    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ssl_context: Optional[ssl.SSLContext] = None,
        token_path: Optional[str] = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self._token = token
        self._token_path = token_path  # projected tokens rotate; re-read per request batch
        self._ssl = ssl_context
        self._session = None  # aiohttp.ClientSession, created lazily

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_config(cls, kube_config_path: str = "") -> "RestKubeClient":
        """Kubeconfig-or-in-cluster (reference app_dependencies.go:38-47)."""
        path = kube_config_path or os.environ.get("KUBECONFIG", "")
        if path:
            return cls.from_kubeconfig(path)
        return cls.in_cluster()

    @classmethod
    def in_cluster(cls) -> "RestKubeClient":
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise KubeClientError(
                "not in cluster (KUBERNETES_SERVICE_HOST unset) and no kubeconfig path given"
            )
        token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
        ca_path = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
        ctx = ssl.create_default_context(cafile=ca_path if os.path.exists(ca_path) else None)
        return cls(f"https://{host}:{port}", ssl_context=ctx, token_path=token_path)

    @classmethod
    def from_kubeconfig(cls, path: str, context: Optional[str] = None) -> "RestKubeClient":
        path = os.path.expanduser(path)  # config files say "~/.kube/config"
        with open(path, "r", encoding="utf-8") as fh:
            import yaml  # at use: the workload path never loads it

            cfg = yaml.safe_load(fh)
        ctx_name = context or cfg.get("current-context")
        ctx_entry = next(
            (c["context"] for c in cfg.get("contexts", []) if c.get("name") == ctx_name), None
        )
        if ctx_entry is None:
            raise KubeClientError(f"kubeconfig context {ctx_name!r} not found in {path}")
        cluster = next(
            (c["cluster"] for c in cfg.get("clusters", []) if c.get("name") == ctx_entry["cluster"]),
            None,
        )
        user = next(
            (u["user"] for u in cfg.get("users", []) if u.get("name") == ctx_entry["user"]), {}
        )
        if cluster is None:
            raise KubeClientError(f"kubeconfig cluster {ctx_entry.get('cluster')!r} not found")
        server = cluster["server"]
        ssl_ctx: Optional[ssl.SSLContext] = None
        if server.startswith("https"):
            ca_data = cluster.get("certificate-authority-data")
            ca_file = cluster.get("certificate-authority")
            if ca_data:
                ssl_ctx = ssl.create_default_context(cadata=b64decode(ca_data).decode())
            elif ca_file:
                ssl_ctx = ssl.create_default_context(cafile=ca_file)
            else:
                ssl_ctx = ssl.create_default_context()
            if cluster.get("insecure-skip-tls-verify"):
                ssl_ctx.check_hostname = False
                ssl_ctx.verify_mode = ssl.CERT_NONE
            cert_data, key_data = user.get("client-certificate-data"), user.get("client-key-data")
            cert_file, key_file = user.get("client-certificate"), user.get("client-key")
            if cert_data and key_data:
                # mTLS material must be on disk for load_cert_chain
                cf = tempfile.NamedTemporaryFile(suffix=".crt", delete=False)
                kf = tempfile.NamedTemporaryFile(suffix=".key", delete=False)
                cf.write(b64decode(cert_data)); cf.close()
                kf.write(b64decode(key_data)); kf.close()
                ssl_ctx.load_cert_chain(cf.name, kf.name)
            elif cert_file and key_file:
                ssl_ctx.load_cert_chain(cert_file, key_file)
        token = user.get("token")
        return cls(server, token=token, ssl_context=ssl_ctx)

    # -- plumbing -------------------------------------------------------------

    def _headers(self) -> Dict[str, str]:
        headers = {"Accept": "application/json"}
        token = self._token
        if self._token_path and os.path.exists(self._token_path):
            with open(self._token_path, "r", encoding="utf-8") as fh:
                token = fh.read().strip()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        return headers

    async def _ensure_session(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    def _path(self, kind: str, namespace: str, name: str = "") -> str:
        try:
            prefix, resource = KIND_API[kind]
        except KeyError:
            raise KubeClientError(f"unknown kind {kind!r}") from None
        path = f"{self.base_url}/{prefix}"
        if namespace:
            path += f"/namespaces/{namespace}"
        path += f"/{resource}"
        if name:
            path += f"/{name}"
        return path

    @staticmethod
    async def _raise_for_status(resp) -> None:  # noqa: ANN001
        if resp.status == 404:
            raise NotFoundError(await resp.text())
        if resp.status >= 400:
            raise KubeClientError(f"HTTP {resp.status}: {(await resp.text())[:500]}")

    # -- KubeClient surface ---------------------------------------------------

    async def list_objects(self, kind: str, namespace: str) -> Tuple[List[Dict[str, Any]], str]:
        session = await self._ensure_session()
        async with session.get(
            self._path(kind, namespace), headers=self._headers(), ssl=self._ssl
        ) as resp:
            await self._raise_for_status(resp)
            payload = await resp.json()
        items = payload.get("items", [])
        # single-kind lists omit per-item kind; restore it for typed views
        for item in items:
            item.setdefault("kind", kind)
        return items, (payload.get("metadata") or {}).get("resourceVersion", "")

    async def watch_objects(
        self, kind: str, namespace: str, resource_version: Optional[str] = None
    ) -> AsyncIterator[Tuple[str, Dict[str, Any]]]:
        session = await self._ensure_session()
        params = {"watch": "1", "allowWatchBookmarks": "true"}
        if resource_version:
            params["resourceVersion"] = resource_version
        async with session.get(
            self._path(kind, namespace),
            headers=self._headers(),
            params=params,
            ssl=self._ssl,
            timeout=None,
        ) as resp:
            await self._raise_for_status(resp)
            buffer = b""
            async for chunk in resp.content.iter_any():
                buffer += chunk
                while b"\n" in buffer:
                    line, buffer = buffer.split(b"\n", 1)
                    if not line.strip():
                        continue
                    try:
                        evt = json.loads(line)
                    except json.JSONDecodeError as exc:
                        raise KubeClientError(f"malformed watch line: {line[:200]!r}") from exc
                    event_type = evt.get("type", "")
                    obj = evt.get("object", {}) or {}
                    if event_type == "ERROR":
                        # e.g. 410 Gone: resourceVersion too old -> caller
                        # re-lists (informer loop handles this)
                        raise KubeClientError(f"watch error: {obj.get('message', '')}")
                    obj.setdefault("kind", kind)
                    yield event_type, obj

    async def create_object(self, kind: str, namespace: str, manifest: Dict[str, Any]) -> Dict[str, Any]:
        session = await self._ensure_session()
        async with session.post(
            self._path(kind, namespace),
            headers={**self._headers(), "Content-Type": "application/json"},
            data=json.dumps(manifest),
            ssl=self._ssl,
        ) as resp:
            await self._raise_for_status(resp)
            return await resp.json()

    async def delete_object(
        self,
        kind: str,
        namespace: str,
        name: str,
        propagation: str = PROPAGATION_BACKGROUND,
    ) -> None:
        if not name:
            # _path(name="") is the COLLECTION url — a DELETE there is a
            # namespace-wide deletecollection, never what a supervisor
            # decision means.  Refuse loudly.
            raise KubeClientError(f"refusing DELETE with empty name (kind={kind!r}, ns={namespace!r})")
        session = await self._ensure_session()
        body = {"kind": "DeleteOptions", "apiVersion": "v1", "propagationPolicy": propagation}
        async with session.delete(
            self._path(kind, namespace, name),
            headers={**self._headers(), "Content-Type": "application/json"},
            data=json.dumps(body),
            ssl=self._ssl,
        ) as resp:
            await self._raise_for_status(resp)
            await resp.read()

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None
