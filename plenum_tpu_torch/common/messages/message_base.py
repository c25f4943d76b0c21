"""MessageBase: declarative typed message schemas validated on construction.

Reference: plenum/common/messages/message_base.py — `schema` is a tuple of
(field_name, FieldValidator); messages construct from positional or keyword
args, validate immediately, serialize to a plain dict with `op` = typename.
"""
from typing import Any, Dict, Optional, Tuple

from plenum_tpu_torch.common.constants import OP_FIELD_NAME
from plenum_tpu_torch.common.exceptions import InvalidNodeMessageException
from plenum_tpu_torch.common.messages.fields import FieldValidator


class MessageValidationError(InvalidNodeMessageException):
    pass


class MessageBase:
    typename: str = None
    schema: Tuple[Tuple[str, FieldValidator], ...] = ()
    # per-class caches derived from schema (set by __init_subclass__;
    # rebuilding these per message construction dominated the hot wire
    # path before)
    _schema_names: Tuple[str, ...] = ()
    _schema_name_set: frozenset = frozenset()
    # fields not included in the digest/signature
    _frozen = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._schema_names = tuple(name for name, _ in cls.schema)
        cls._schema_name_set = frozenset(cls._schema_names)

    def __init__(self, *args, **kwargs):
        field_names = self._schema_names
        if len(args) > len(field_names):
            raise MessageValidationError(
                "too many positional arguments for {}".format(self.typename))
        values: Dict[str, Any] = dict(zip(field_names, args))
        for k, v in kwargs.items():
            if k in values:
                raise MessageValidationError(
                    "duplicate argument {} for {}".format(k, self.typename))
            if k not in self._schema_name_set:
                raise MessageValidationError(
                    "unknown argument {} for {}".format(k, self.typename))
            values[k] = v
        self._validate_and_set(values)
        self._frozen = True

    def _validate_and_set(self, values: Dict[str, Any]):
        for name, validator in self.schema:
            if name not in values or values[name] is None:
                if validator.optional or validator.nullable:
                    values.setdefault(name, None)
                    continue
                raise MessageValidationError(
                    "validation error [{}]: missed fields - {}"
                    .format(type(self).__name__, name))
            err = validator.validate(values[name])
            if err:
                raise MessageValidationError(
                    "validation error [{}]: {} ({}={})"
                    .format(type(self).__name__, err, name,
                            repr(values[name])[:128]))
        for name in self._schema_names:
            object.__setattr__(self, name, values.get(name))

    def __setattr__(self, key, value):
        if self._frozen and key in self._schema_name_set:
            raise AttributeError("message fields are immutable")
        object.__setattr__(self, key, value)

    @property
    def _field_names(self):
        return self._schema_names

    def as_dict(self) -> Dict[str, Any]:
        """Plain-dict form of the payload, tuples normalized to lists so
        dict equality and canonical serialization are stable."""
        return {name: _plain(getattr(self, name)) for name in self._field_names}

    def to_dict(self) -> Dict[str, Any]:
        """Wire form: payload + op field."""
        d = self.as_dict()
        d[OP_FIELD_NAME] = self.typename
        return d

    def items(self):
        return self.as_dict().items()

    def __getitem__(self, item):
        if isinstance(item, int):
            return getattr(self, self._field_names[item])
        return getattr(self, item)

    def __iter__(self):
        return iter(getattr(self, name) for name in self._field_names)

    def __len__(self):
        return len(self.schema)

    def __eq__(self, other):
        if not isinstance(other, MessageBase):
            return NotImplemented
        return self.typename == other.typename and self.as_dict() == other.as_dict()

    def __hash__(self):
        return hash((self.typename, _hashable(self.as_dict())))

    def __repr__(self):
        return "{}({})".format(
            type(self).__name__,
            ", ".join("{}={!r}".format(n, getattr(self, n))
                      for n in self._field_names))


def _plain(v):
    # Exact-type fast paths first: wire payloads are overwhelmingly
    # plain scalars/dicts (txn envelopes in Replies, request dicts in
    # Propagates) and the recursion over them is pure copying — this
    # runs per field per outgoing message. CONTRACT: a container that
    # needs no conversion is returned BY REFERENCE, so as_dict()/
    # to_dict() output must be treated as read-only below the top
    # level (a nested mutation would write through into the frozen
    # message). Tuples always convert — as_dict's list normalization
    # is what keeps local-vs-wire message equality stable.
    t = type(v)
    if t is str or t is int or t is bool or t is float or v is None:
        return v
    if t is dict:
        if not _needs_conversion(v):
            return v
        return _convert(v)
    if isinstance(v, MessageBase):
        return v.as_dict()
    if isinstance(v, (list, tuple)):
        if t is list and not _needs_conversion(v):
            return v
        return _convert(v)
    if isinstance(v, dict):
        return _convert(v)
    return v


def _convert(v):
    """Unconditional deep rebuild (the pre-fast-path behavior): used
    once a subtree is known to need conversion, so clean inner nodes
    aren't re-scanned per nesting level."""
    if isinstance(v, MessageBase):
        return v.as_dict()
    if isinstance(v, (list, tuple)):
        return [_convert(x) for x in v]
    if isinstance(v, dict):
        return {k: _convert(x) for k, x in v.items()}
    return v


_PLAIN_TYPES = (str, int, bool, float, type(None), bytes)


def _needs_conversion(v, _depth=0) -> bool:
    """True if anything inside a plain container requires _plain to
    rebuild it: a MessageBase, an exotic type, or a TUPLE (which must
    normalize to a list so deserialized copies compare equal)."""
    if _depth > 12:
        return True  # absurd nesting: fall back to the copying path
    t = type(v)
    if t in _PLAIN_TYPES:
        return False
    if t is dict:
        return any(_needs_conversion(x, _depth + 1) for x in v.values())
    if t is list:
        return any(_needs_conversion(x, _depth + 1) for x in v)
    return True  # MessageBase, tuple, or exotic type: must convert


def _hashable(v):
    """Order-insensitive hashable form: equal as_dict()s (dict equality
    ignores insertion order) must hash identically."""
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    return v
