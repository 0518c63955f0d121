"""The port's node package (``p1_tpu/node/__init__.py``'s exports)."""

from p1_tpu_torch.node.client import send_tx
from p1_tpu_torch.node.node import Node, NodeMetrics
from p1_tpu_torch.node.protocol import Hello, MsgType
from p1_tpu_torch.node.transport import SocketTransport, Transport

__all__ = [
    "Node",
    "NodeMetrics",
    "Hello",
    "MsgType",
    "send_tx",
    "SocketTransport",
    "Transport",
]
