"""Client request schema validation.

Reference: plenum/common/messages/client_request.py:234 —
ClientMessageValidator checks the envelope; operation schemas are
per-txn-type (registered by request handlers for static validation).
"""
from plenum_tpu_torch.common.constants import (
    CURRENT_PROTOCOL_VERSION, IDENTIFIER, OPERATION, REQ_ID, SIGNATURE,
    SIGNATURES, TAA_ACCEPTANCE, TAA_ACCEPTANCE_DIGEST,
    TAA_ACCEPTANCE_MECHANISM, TAA_ACCEPTANCE_TIME, TXN_TYPE)
from plenum_tpu_torch.common.exceptions import InvalidClientRequest
from plenum_tpu_torch.common.messages.fields import (
    IdentifierField, LimitedLengthStringField, MapField, NonEmptyStringField,
    NonNegativeNumberField, ProtocolVersionField, Sha256HexField,
    SignatureField, TimestampField)
from plenum_tpu_torch.ops.cuda_lib import try_load_host_ext

_fp = try_load_host_ext("fastpath")


class ClientTAAAcceptance:
    schema = (
        (TAA_ACCEPTANCE_DIGEST, Sha256HexField()),
        (TAA_ACCEPTANCE_MECHANISM, LimitedLengthStringField()),
        (TAA_ACCEPTANCE_TIME, NonNegativeNumberField()),
    )


class ClientMessageValidator:
    """Validates the client request envelope dict."""

    schema = (
        (IDENTIFIER, IdentifierField(nullable=True)),
        (REQ_ID, NonNegativeNumberField()),
        (OPERATION, None),  # checked structurally below
        (SIGNATURE, SignatureField(nullable=True)),
        (SIGNATURES, MapField(IdentifierField(), SignatureField(),
                              nullable=True)),
        ('protocolVersion', ProtocolVersionField(nullable=True)),
        (TAA_ACCEPTANCE, None),
    )

    def __init__(self, operation_schema_is_strict: bool = False):
        self._strict = operation_schema_is_strict

    def validate(self, dct: dict):
        # C fast path (fastpath.c validate_client_request): returns None
        # only when the envelope is PROVABLY valid; anything else falls
        # through to the Python checks below, which either pass or raise
        # with their exact error message — clients never see C-made text
        if _fp is not None:
            try:
                if _fp.validate_client_request(
                        dct, CURRENT_PROTOCOL_VERSION) is None:
                    return
            except TypeError:
                pass
        self._validate_py(dct)

    def _validate_py(self, dct: dict):
        if not isinstance(dct, dict):
            raise InvalidClientRequest(None, None, 'request must be a dict')
        identifier = dct.get(IDENTIFIER)
        req_id = dct.get(REQ_ID)
        op = dct.get(OPERATION)
        if op is None:
            raise InvalidClientRequest(identifier, req_id,
                                       'missed fields - operation')
        if not isinstance(op, dict):
            raise InvalidClientRequest(identifier, req_id,
                                       'operation must be a dict')
        if TXN_TYPE not in op:
            raise InvalidClientRequest(identifier, req_id,
                                       'missed fields in operation - type')
        if req_id is None:
            raise InvalidClientRequest(identifier, req_id,
                                       'missed fields - {}'.format(REQ_ID))
        if identifier is None and not dct.get(SIGNATURES):
            raise InvalidClientRequest(
                identifier, req_id,
                'missed fields - {} or {}'.format(IDENTIFIER, SIGNATURES))
        for name, validator in self.schema:
            if validator is None:
                continue
            val = dct.get(name)
            if val is None and (validator.nullable or name not in dct):
                continue
            err = validator.validate(val)
            if err:
                raise InvalidClientRequest(identifier, req_id,
                                           '{} ({})'.format(err, name))
        taa = dct.get(TAA_ACCEPTANCE)
        if taa is not None:
            self._validate_taa(identifier, req_id, taa)

    def _validate_taa(self, identifier, req_id, taa):
        if not isinstance(taa, dict):
            raise InvalidClientRequest(identifier, req_id,
                                       'taaAcceptance must be a dict')
        for name, validator in ClientTAAAcceptance.schema:
            if name not in taa:
                raise InvalidClientRequest(
                    identifier, req_id,
                    'missed fields in taaAcceptance - {}'.format(name))
            err = validator.validate(taa[name])
            if err:
                raise InvalidClientRequest(identifier, req_id,
                                           '{} ({})'.format(err, name))
