"""L7 cluster integration: the API-server adapter layer.

Reference: k8s/ — a thin anti-corruption layer between the scheduler
core and the cluster control plane (k8s/k8sclient/client.go:32-147,
k8s/k8stype/types.go). The rebuild keeps the same boundary: the
scheduler consumes pod/node events and emits bindings through the
ClusterAPI protocol. Backends:

- SyntheticClusterAPI — in-process channels (the fakeMachines role);
- HTTPClusterAPI — the real-control-plane shape: HTTP watch loops
  feeding the same channels, k8s Binding-subresource POSTs out;
- FakeAPIServer — a loopback server speaking the API slice the
  scheduler uses, for hermetic end-to-end runs over real sockets.
"""

from .api import Binding, ClusterAPI, NodeEvent, PodEvent
from .fake_apiserver import FakeAPIServer
from .http_api import HTTPClusterAPI
from .synthetic_api import SyntheticClusterAPI

__all__ = [
    "Binding",
    "ClusterAPI",
    "FakeAPIServer",
    "HTTPClusterAPI",
    "NodeEvent",
    "PodEvent",
    "SyntheticClusterAPI",
]
