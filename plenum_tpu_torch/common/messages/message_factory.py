"""Wire-name → message-class registry for deserialization.

Reference: plenum/common/messages/node_message_factory.py.
"""
from typing import Dict, Type

from plenum_tpu_torch.common.constants import OP_FIELD_NAME
from plenum_tpu_torch.common.exceptions import InvalidNodeOp, MissingNodeOp
from plenum_tpu_torch.common.messages.message_base import MessageBase
from plenum_tpu_torch.common.messages import node_messages


class MessageFactory:
    def __init__(self, *modules):
        self._classes: Dict[str, Type[MessageBase]] = {}
        for module in modules:
            for attr in vars(module).values():
                if (isinstance(attr, type) and issubclass(attr, MessageBase)
                        and attr is not MessageBase
                        and attr.typename is not None):
                    self._classes[attr.typename] = attr

    def get_type(self, typename: str) -> Type[MessageBase]:
        cls = self._classes.get(typename)
        if cls is None:
            raise InvalidNodeOp("unknown message type {}".format(typename))
        return cls

    def get_instance(self, **msg_dict) -> MessageBase:
        typename = msg_dict.pop(OP_FIELD_NAME, None)
        if typename is None:
            raise MissingNodeOp("missed op field")
        cls = self.get_type(typename)
        known = {name for name, _ in cls.schema}
        kwargs = {k: _detuple(v) for k, v in msg_dict.items() if k in known}
        return cls(**kwargs)

    def set_message_class(self, cls: Type[MessageBase]):
        self._classes[cls.typename] = cls


def _detuple(v):
    if isinstance(v, tuple):
        return [_detuple(x) for x in v]
    if isinstance(v, list):
        return [_detuple(x) for x in v]
    return v


node_message_factory = MessageFactory(node_messages)
