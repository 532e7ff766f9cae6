"""Service discovery for the proxy's destination pool.

Parity with reference discovery/ (discoverer.go:5-7, consul/consul.go:30-47,
kubernetes/kubernetes.go:90-108): a Discoverer maps a service name to the
current list of healthy destination addresses. Built-ins:

- StaticDiscoverer: a fixed list (the common config-driven case).
- DnsDiscoverer: resolve an A/AAAA name each refresh; every returned
  address (with a fixed port) is a destination.
- HttpJsonDiscoverer: poll an HTTP endpoint returning a JSON array of
  addresses — the shape any custom controller can serve (tests use a
  local HTTP fake, like the reference's consul testdata).
- ConsulDiscoverer: the Consul health API (passing-only), returning
  Node.Address:Service.Port like the reference
  (consul/consul.go:30-47).
- KubernetesDiscoverer: list pods by label from the kube-apiserver and
  extract grpc/http/TCP container ports from running pods
  (kubernetes/kubernetes.go:34-130), using in-cluster service-account
  credentials by default.
"""

from __future__ import annotations

import abc
import json
import logging
import os
import socket
import ssl
import urllib.parse
import urllib.request
from typing import List, Optional

logger = logging.getLogger("veneur_tpu_torch.proxy.discovery")


class Discoverer(abc.ABC):
    @abc.abstractmethod
    def get_destinations_for_service(self, service: str) -> List[str]: ...


class StaticDiscoverer(Discoverer):
    def __init__(self, destinations: List[str]):
        self._destinations = list(destinations)

    def get_destinations_for_service(self, service: str) -> List[str]:
        return list(self._destinations)


class DnsDiscoverer(Discoverer):
    """`service` is "host:port"; each resolved address becomes a
    destination at that port."""

    def get_destinations_for_service(self, service: str) -> List[str]:
        host, _, port = service.rpartition(":")
        if not host:
            raise ValueError(f"dns discovery needs host:port, got {service!r}")
        infos = socket.getaddrinfo(host, int(port), proto=socket.IPPROTO_TCP)
        # IPv6 literals need brackets to be dialable gRPC targets
        return sorted({
            (f"[{info[4][0]}]:{port}" if info[0] == socket.AF_INET6
             else f"{info[4][0]}:{port}")
            for info in infos})


class HttpJsonDiscoverer(Discoverer):
    """GET `url_template.format(service=...)`, expecting a JSON array of
    "host:port" strings (or of objects with Address/Port keys, the shape
    of a Consul health response)."""

    def __init__(self, url_template: str, timeout: float = 5.0):
        self.url_template = url_template
        self.timeout = timeout

    def get_destinations_for_service(self, service: str) -> List[str]:
        url = self.url_template.format(service=service)
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            payload = json.load(resp)
        out = []
        for entry in payload:
            if isinstance(entry, str):
                out.append(entry)
            elif isinstance(entry, dict):
                # Consul-style: {"Service": {"Address": ..., "Port": ...}}
                svc = entry.get("Service", entry)
                addr = svc.get("Address") or entry.get("Node", {}).get(
                    "Address")
                port = svc.get("Port")
                if addr and port:
                    out.append(f"{addr}:{port}")
        return out


class ConsulDiscoverer(Discoverer):
    """Healthy service instances from the Consul HTTP health API
    (reference discovery/consul/consul.go:30-47): destinations are
    "<node address>:<service port>" of passing entries only; an empty
    result is an error, matching the reference's "received no hosts"."""

    def __init__(self, base_url: str = "http://127.0.0.1:8500",
                 token: str = "", timeout: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout

    def get_destinations_for_service(self, service: str) -> List[str]:
        url = (f"{self.base_url}/v1/health/service/"
               f"{urllib.parse.quote(service)}?passing=true")
        req = urllib.request.Request(url)
        if self.token:
            req.add_header("X-Consul-Token", self.token)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            entries = json.load(resp)
        if not entries:
            raise RuntimeError("received no hosts from Consul")
        hosts = []
        for entry in entries:
            node_addr = entry.get("Node", {}).get("Address")
            svc = entry.get("Service", {})
            port = svc.get("Port")
            if node_addr and port:
                hosts.append(f"{node_addr}:{port}")
        return hosts


class KubernetesDiscoverer(Discoverer):
    """Pod-list discovery against the kube-apiserver (reference
    discovery/kubernetes/kubernetes.go:90-130): list pods matching
    `label_selector`, keep Running pods, and pick the forward port per
    pod. Only container ports named "grpc" become destinations: the
    reference also emitted "http://"-prefixed destinations for http/TCP
    ports (its retired legacy-HTTP import), but this framework forwards
    over gRPC only, so such pods are skipped with a warning instead of
    claiming ring keyspace they could never serve.

    By default reads in-cluster credentials (KUBERNETES_SERVICE_HOST /
    _PORT, the service-account token and CA bundle); every piece can be
    overridden, which is also how tests point it at a fake API server."""

    SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(self, api_base: Optional[str] = None,
                 token: Optional[str] = None,
                 ca_file: Optional[str] = None,
                 label_selector: str = "app=veneur-global",
                 timeout: float = 10.0):
        if api_base is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not in a Kubernetes cluster (KUBERNETES_SERVICE_HOST "
                    "unset) and no api_base given")
            api_base = f"https://{host}:{port}"
        self.api_base = api_base.rstrip("/")
        if token is None:
            token_path = os.path.join(self.SA_DIR, "token")
            token = (open(token_path).read().strip()
                     if os.path.exists(token_path) else "")
        self.token = token
        if ca_file is None:
            ca_path = os.path.join(self.SA_DIR, "ca.crt")
            ca_file = ca_path if os.path.exists(ca_path) else None
        self._ctx = None
        if self.api_base.startswith("https"):
            self._ctx = ssl.create_default_context(cafile=ca_file)
        self.label_selector = label_selector
        self.timeout = timeout

    def _destination_from_pod(self, pod: dict) -> str:
        status = pod.get("status", {})
        if status.get("phase") != "Running":
            return ""
        name = pod.get("metadata", {}).get("name", "?")
        forward_port = ""
        saw_legacy = False
        for container in pod.get("spec", {}).get("containers", []):
            for port in container.get("ports", []):
                if port.get("name") == "grpc":
                    forward_port = str(port.get("containerPort", ""))
                    break
                if (port.get("name") == "http"
                        or port.get("protocol") == "TCP"):
                    saw_legacy = True
            else:
                continue
            break
        pod_ip = status.get("podIP", "")
        if forward_port in ("", "0"):
            if saw_legacy:
                # the reference forwarded these over its legacy HTTP
                # import; this build is gRPC-only, so they are not
                # dialable destinations
                logger.warning(
                    "pod %s exposes only http/TCP ports; skipping "
                    "(gRPC-only forward plane)", name)
            else:
                logger.error("pod %s: no grpc port for forwarding", name)
            return ""
        if not pod_ip:
            logger.error("pod %s: no podIP for forwarding", name)
            return ""
        return f"{pod_ip}:{forward_port}"

    def get_destinations_for_service(self, service: str) -> List[str]:
        selector = urllib.parse.quote(self.label_selector)
        url = f"{self.api_base}/api/v1/pods?labelSelector={selector}"
        req = urllib.request.Request(url)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        with urllib.request.urlopen(
                req, timeout=self.timeout, context=self._ctx) as resp:
            payload = json.load(resp)
        out = []
        for pod in payload.get("items", []):
            dest = self._destination_from_pod(pod)
            if dest:
                out.append(dest)
        return out
