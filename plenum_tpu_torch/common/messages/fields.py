"""Declarative field validators for wire messages.

Reference: plenum/common/messages/fields.py (748 LoC, ~50 validators) — these
are the wire-compat spec of the protocol. A validator's `validate(value)`
returns None when valid, else an error string.

Parity delta vs the reference's class list (enumerated r5): the
reference-only names are `FieldBase` (its ABC — `FieldValidator` here
fills that role), `LedgerInfoField` (used ONLY by the legacy
ViewChangeDone message of the pre-"plenum 2.0" view-change protocol,
node_messages.py:434 — superseded by ViewChange/NewView, which this
framework implements natively), and `TieAmongField` (no non-test usage
in the reference at all — vestige of the removed election protocol).
This module adds `AlphaNumericField`, `Base64Field`, and
`PositiveNumberField`, which the reference folds into ad-hoc checks.
Every validator used by a LIVE reference message type has an equivalent
here.
"""
import base64
import ipaddress
import json
import re
from abc import ABC, abstractmethod
from datetime import datetime
from typing import Iterable, Optional

from plenum_tpu_torch.common.serializers.base58 import b58decode


class FieldValidator(ABC):
    optional = False

    def __init__(self, optional: bool = False, nullable: bool = False):
        self.optional = optional
        self.nullable = nullable

    def validate(self, val) -> Optional[str]:
        if val is None:
            if self.nullable:
                return None
            return 'expected not-None value'
        return self._specific_validation(val)

    @abstractmethod
    def _specific_validation(self, val) -> Optional[str]:
        ...


class AnyField(FieldValidator):
    def _specific_validation(self, val):
        return None


class BooleanField(FieldValidator):
    def _specific_validation(self, val):
        if not isinstance(val, bool):
            return 'expected types bool, got {}'.format(type(val).__name__)


class IntegerField(FieldValidator):
    def _specific_validation(self, val):
        if not isinstance(val, int) or isinstance(val, bool):
            return 'expected types int, got {}'.format(type(val).__name__)


class NonNegativeNumberField(IntegerField):
    def _specific_validation(self, val):
        err = super()._specific_validation(val)
        if err:
            return err
        if val < 0:
            return 'negative value'


class PositiveNumberField(IntegerField):
    def _specific_validation(self, val):
        err = super()._specific_validation(val)
        if err:
            return err
        if val <= 0:
            return 'non-positive value'


class NonEmptyStringField(FieldValidator):
    def _specific_validation(self, val):
        if not isinstance(val, str):
            return 'expected types str, got {}'.format(type(val).__name__)
        if not val:
            return 'empty string'


class LimitedLengthStringField(FieldValidator):
    def __init__(self, max_length: int = 256, **kwargs):
        super().__init__(**kwargs)
        assert max_length > 0
        self._max_length = max_length

    def _specific_validation(self, val):
        if not isinstance(val, str):
            return 'expected types str, got {}'.format(type(val).__name__)
        if not val:
            return 'empty string'
        if len(val) > self._max_length:
            return '{} is longer than {} symbols'.format(val[:100], self._max_length)


class FixedLengthField(FieldValidator):
    def __init__(self, length: int, **kwargs):
        super().__init__(**kwargs)
        self._length = length

    def _specific_validation(self, val):
        if not isinstance(val, str):
            return 'expected types str, got {}'.format(type(val).__name__)
        if len(val) != self._length:
            return 'should have length {}'.format(self._length)


class SignatureField(LimitedLengthStringField):
    def __init__(self, max_length: int = 512, **kwargs):
        super().__init__(max_length=max_length, **kwargs)


class RoleField(FieldValidator):
    def __init__(self, roles=("0", "2", None), **kwargs):
        kwargs.setdefault('nullable', True)
        super().__init__(**kwargs)
        self._roles = roles

    def _specific_validation(self, val):
        if val not in self._roles:
            return 'expected one of {}'.format(self._roles)


class Base58Field(FieldValidator):
    def __init__(self, byte_lengths: Iterable[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.byte_lengths = tuple(byte_lengths) if byte_lengths else None

    def _specific_validation(self, val):
        if not isinstance(val, str):
            return 'expected types str, got {}'.format(type(val).__name__)
        try:
            raw = b58decode(val)
        except Exception:
            return 'should not contain chars other than base58'
        if self.byte_lengths is not None and len(raw) not in self.byte_lengths:
            return 'b58 decoded value length {} should be one of {}'.format(
                len(raw), list(self.byte_lengths))


class DestNodeField(Base58Field):
    """Node target: 16 or 32 byte base58 (verkey or abbreviated)."""
    def __init__(self, **kwargs):
        super().__init__(byte_lengths=(16, 32), **kwargs)


class DestNymField(Base58Field):
    def __init__(self, **kwargs):
        super().__init__(byte_lengths=(16, 32), **kwargs)


class IdentifierField(Base58Field):
    def __init__(self, **kwargs):
        super().__init__(byte_lengths=(16, 32), **kwargs)


class FullVerkeyField(Base58Field):
    def __init__(self, **kwargs):
        super().__init__(byte_lengths=(32,), **kwargs)


class AbbreviatedVerkeyField(FieldValidator):
    """'~' + 16-byte base58 (the abbreviated verkey form)."""
    def _specific_validation(self, val):
        if not isinstance(val, str) or not val.startswith('~'):
            return 'should start with ~'
        return Base58Field(byte_lengths=(16,))._specific_validation(val[1:])


class VerkeyField(FieldValidator):
    def _specific_validation(self, val):
        if not isinstance(val, str):
            return 'expected types str, got {}'.format(type(val).__name__)
        if val.startswith('~'):
            return AbbreviatedVerkeyField()._specific_validation(val)
        return FullVerkeyField()._specific_validation(val)


class MerkleRootField(Base58Field):
    def __init__(self, **kwargs):
        super().__init__(byte_lengths=(32,), **kwargs)


class TimestampField(FieldValidator):
    _oldest_time = 1499906902  # reference fields.py TimestampField

    def _specific_validation(self, val):
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            return 'expected types int or float, got {}'.format(type(val).__name__)
        if val < self._oldest_time:
            return 'should be greater than {} but was {}'.format(
                self._oldest_time, val)


class LedgerIdField(FieldValidator):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        from plenum_tpu_torch.common.constants import VALID_LEDGER_IDS
        self.ledger_ids = VALID_LEDGER_IDS

    def _specific_validation(self, val):
        if val not in self.ledger_ids:
            return 'expected one of {}, unknown ledger id {}'.format(
                self.ledger_ids, val)


class RequestIdentifierField(FieldValidator):
    def _specific_validation(self, val):
        if not isinstance(val, (list, tuple)) or len(val) != 2:
            return 'should be a list/tuple of 2 elements'
        err = IdentifierField()._specific_validation(val[0])
        if err:
            return err
        return NonNegativeNumberField()._specific_validation(val[1])


class IterableField(FieldValidator):
    def __init__(self, inner_field_type: FieldValidator, min_length=None,
                 max_length=None, **kwargs):
        super().__init__(**kwargs)
        self.inner_field_type = inner_field_type
        self.min_length = min_length
        self.max_length = max_length

    def _specific_validation(self, val):
        if not isinstance(val, (list, tuple)):
            return 'expected types list or tuple, got {}'.format(type(val).__name__)
        if self.min_length is not None and len(val) < self.min_length:
            return 'length should be at least {}'.format(self.min_length)
        if self.max_length is not None and len(val) > self.max_length:
            return 'length should be at most {}'.format(self.max_length)
        for v in val:
            err = self.inner_field_type.validate(v)
            if err:
                return err


class MapField(FieldValidator):
    def __init__(self, key_field: FieldValidator, value_field: FieldValidator,
                 **kwargs):
        super().__init__(**kwargs)
        self.key_field = key_field
        self.value_field = value_field

    def _specific_validation(self, val):
        if not isinstance(val, dict):
            return 'expected types dict, got {}'.format(type(val).__name__)
        for k, v in val.items():
            err = self.key_field.validate(k)
            if err:
                return err
            err = self.value_field.validate(v)
            if err:
                return err


class AnyMapField(FieldValidator):
    def _specific_validation(self, val):
        if not isinstance(val, dict):
            return 'expected types dict, got {}'.format(type(val).__name__)


class NetworkPortField(FieldValidator):
    def _specific_validation(self, val):
        if not isinstance(val, int) or isinstance(val, bool):
            return 'expected types int, got {}'.format(type(val).__name__)
        if val <= 0 or val > 65535:
            return 'network port out of the range 1-65535'


class NetworkIpAddressField(FieldValidator):
    def _specific_validation(self, val):
        if not isinstance(val, str):
            return 'expected types str, got {}'.format(type(val).__name__)
        invalid = ('0.0.0.0', '0:0:0:0:0:0:0:0', '::')
        try:
            ipaddress.ip_address(val)
        except ValueError:
            return 'invalid network ip address ({})'.format(val)
        if val in invalid:
            return 'invalid network ip address ({})'.format(val)


class ChooseField(FieldValidator):
    def __init__(self, values, **kwargs):
        super().__init__(**kwargs)
        self._possible_values = tuple(values)

    def _specific_validation(self, val):
        if val not in self._possible_values:
            return 'expected one of {}, unknown value {}'.format(
                self._possible_values, val)


class ConstantField(FieldValidator):
    """Exactly one permitted value (reference fields.py ConstantField)."""

    def __init__(self, value, **kwargs):
        super().__init__(**kwargs)
        self._value = value

    def _specific_validation(self, val):
        if val != self._value:
            return 'has to be equal {}'.format(self._value)


class DatetimeStringField(FieldValidator):
    """ISO-8601 datetime string (reference fields.py
    DatetimeStringField — TAA acceptance-mechanism timestamps)."""

    def _specific_validation(self, val):
        if not isinstance(val, str):
            return 'expected types str, got {}'.format(type(val).__name__)
        try:
            datetime.fromisoformat(val)
        except ValueError:
            return 'datetime {} is not valid ISO 8601'.format(val)


class HexField(FieldValidator):
    def __init__(self, length=None, **kwargs):
        super().__init__(**kwargs)
        self._length = length

    def _specific_validation(self, val):
        if not isinstance(val, str):
            return 'expected types str, got {}'.format(type(val).__name__)
        try:
            int(val, 16)
        except ValueError:
            return 'invalid hex number {}'.format(val[:64])
        if self._length is not None and len(val) != self._length:
            return 'length should be {} length'.format(self._length)


class Sha256HexField(HexField):
    def __init__(self, **kwargs):
        super().__init__(length=64, **kwargs)


class JsonField(LimitedLengthStringField):
    def __init__(self, max_length: int = 5 * 1024, **kwargs):
        super().__init__(max_length=max_length, **kwargs)

    def _specific_validation(self, val):
        err = super()._specific_validation(val)
        if err:
            return err
        try:
            json.loads(val)
        except json.JSONDecodeError:
            return 'should be a valid JSON string'


class SerializedValueField(FieldValidator):
    def _specific_validation(self, val):
        if not isinstance(val, (str, bytes)):
            return 'expected types str or bytes, got {}'.format(type(val).__name__)
        if not val:
            return 'empty serialized value'


class Base64Field(FieldValidator):
    def _specific_validation(self, val):
        try:
            base64.b64decode(val, validate=True)
        except Exception:
            return 'should be a valid base64 string'


class VersionField(FieldValidator):
    """Dotted numeric version, 1-3 components (reference fields.py)."""
    def __init__(self, components_number=(3,), **kwargs):
        super().__init__(**kwargs)
        self._comp_num = components_number

    def _specific_validation(self, val):
        if not isinstance(val, str):
            return 'expected types str, got {}'.format(type(val).__name__)
        parts = val.split('.')
        if len(parts) not in self._comp_num:
            return 'version consists of {} components, but it should contain {}'\
                .format(len(parts), self._comp_num)
        for p in parts:
            if not p.isdigit():
                return 'version component should contain only digits'


class ProtocolVersionField(FieldValidator):
    def __init__(self, **kwargs):
        kwargs.setdefault('nullable', True)
        super().__init__(**kwargs)

    def _specific_validation(self, val):
        from plenum_tpu_torch.common.constants import CURRENT_PROTOCOL_VERSION
        if not isinstance(val, int) or isinstance(val, bool):
            return 'expected types int, got {}'.format(type(val).__name__)
        if val != CURRENT_PROTOCOL_VERSION:
            return 'Unknown protocol version value {}'.format(val)


class BlsMultiSignatureValueField(FieldValidator):
    """(ledger_id, state_root, pool_state_root, txn_root, timestamp)
    (reference fields.py BlsMultiSignatureValueField)."""
    def _specific_validation(self, val):
        if not isinstance(val, (list, tuple)) or len(val) != 5:
            return 'should be a list of 5 elements'
        lid, state_root, pool_root, txn_root, ts = val
        err = LedgerIdField()._specific_validation(lid)
        if err:
            return err
        for root in (state_root, pool_root, txn_root):
            err = MerkleRootField()._specific_validation(root)
            if err:
                return err
        return TimestampField()._specific_validation(ts)


class BlsMultiSignatureField(FieldValidator):
    """(signature, participants, value) (reference fields.py)."""
    def _specific_validation(self, val):
        if not isinstance(val, (list, tuple)) or len(val) != 3:
            return 'should be a list of 3 elements'
        sig, participants, value = val
        err = NonEmptyStringField()._specific_validation(sig)
        if err:
            return err
        err = IterableField(NonEmptyStringField(),
                            min_length=1)._specific_validation(participants)
        if err:
            return err
        return BlsMultiSignatureValueField()._specific_validation(value)


class BatchIDField(FieldValidator):
    """(view_no, pp_view_no, pp_seq_no, pp_digest) (reference fields.py)."""
    def _specific_validation(self, val):
        if not isinstance(val, (list, tuple)) or len(val) != 4:
            return 'should be a list of 4 elements'
        for n in val[:3]:
            err = NonNegativeNumberField()._specific_validation(n)
            if err:
                return err
        return NonEmptyStringField()._specific_validation(val[3])


class ViewChangeField(FieldValidator):
    """(frm, view_change_digest)."""
    def _specific_validation(self, val):
        if not isinstance(val, (list, tuple)) or len(val) != 2:
            return 'should be a list of 2 elements'
        err = NonEmptyStringField()._specific_validation(val[0])
        if err:
            return err
        return NonEmptyStringField()._specific_validation(val[1])


class StringifiedNonNegativeNumberField(FieldValidator):
    def _specific_validation(self, val):
        if isinstance(val, int) and not isinstance(val, bool):
            return NonNegativeNumberField()._specific_validation(val)
        if isinstance(val, str):
            if not val.isdigit():
                return 'stringified int expected, but was {}'.format(val[:32])
            return None
        return 'expected types str or int, got {}'.format(type(val).__name__)


class TxnSeqNoField(PositiveNumberField):
    pass


class MessageField(FieldValidator):
    """A nested MessageBase instance (or its dict form)."""
    def __init__(self, message_type=None, **kwargs):
        super().__init__(**kwargs)
        self._message_type = message_type

    def _specific_validation(self, val):
        if self._message_type is not None and isinstance(val, self._message_type):
            return None
        if isinstance(val, dict):
            return None
        return 'expected a message or dict, got {}'.format(type(val).__name__)


class AnyValueField(FieldValidator):
    def __init__(self, **kwargs):
        kwargs.setdefault('nullable', True)
        super().__init__(**kwargs)

    def _specific_validation(self, val):
        return None


class AlphaNumericField(FieldValidator):
    _pattern = re.compile(r'^[A-Za-z0-9]+$')

    def _specific_validation(self, val):
        if not isinstance(val, str):
            return 'expected types str, got {}'.format(type(val).__name__)
        if not self._pattern.match(val):
            return 'should contain only alphanumeric characters'
