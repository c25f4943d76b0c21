"""Exception hierarchy (reference: common/exceptions.py:5 PlenumError,
plenum/common/exceptions.py)."""


class PlenumError(Exception):
    """Base for all framework errors."""


class PlenumTypeError(PlenumError, TypeError):
    def __init__(self, v_name, v_value, v_exp_t, *args):
        super().__init__("variable '{}', type {}, expected: {}"
                         .format(v_name, type(v_value), v_exp_t), *args)


class PlenumValueError(PlenumError, ValueError):
    def __init__(self, v_name, v_value, v_exp_value, *args):
        super().__init__("variable '{}', value {}, expected: {}"
                         .format(v_name, v_value, v_exp_value), *args)


class LogicError(PlenumError, RuntimeError):
    """Intended to be raised when an internal invariant is broken."""


class InvalidMessageException(PlenumError):
    pass


class MissingNodeOp(InvalidMessageException):
    pass


class InvalidNodeOp(InvalidMessageException):
    pass


class InvalidNodeMessageException(InvalidMessageException):
    pass


class InvalidClientMessageException(InvalidMessageException):
    def __init__(self, identifier, reqId, reason=None, code=None):
        self.identifier = identifier
        self.reqId = reqId
        self.reason = reason
        self.code = code
        super().__init__(reason or "invalid client message")


class InvalidClientRequest(InvalidClientMessageException):
    pass


class InvalidClientTaaAcceptanceError(InvalidClientRequest):
    pass


class UnauthorizedClientRequest(InvalidClientMessageException):
    pass


class InvalidSignature(InvalidClientMessageException):
    def __init__(self, identifier=None, reqId=None, reason="invalid signature"):
        super().__init__(identifier, reqId, reason)


class CouldNotAuthenticate(InvalidClientMessageException):
    pass


class InsufficientSignatures(InvalidClientMessageException):
    def __init__(self, provided, required, identifier=None, reqId=None):
        super().__init__(identifier, reqId,
                         "insufficient signatures, {} provided but {} required"
                         .format(provided, required))


class InsufficientCorrectSignatures(InvalidClientMessageException):
    def __init__(self, valid, required, identifier=None, reqId=None):
        super().__init__(identifier, reqId,
                         "insufficient number of valid signatures, {} is valid "
                         "but {} required".format(valid, required))


class SuspiciousNode(PlenumError):
    def __init__(self, node: str, suspicion, offending_msg=None):
        self.node = node
        self.suspicion = suspicion
        self.offendingMsg = offending_msg
        code = getattr(suspicion, 'code', None)
        reason = getattr(suspicion, 'reason', suspicion)
        super().__init__("suspicious node {}: ({}) {}".format(node, code, reason))


class SuspiciousClient(PlenumError):
    pass


class BlowUp(PlenumError):
    """Unrecoverable error: the node must halt."""


class StorageException(PlenumError):
    pass


class KeysNotFoundException(PlenumError):
    pass


class MismatchedMessageReplyException(PlenumError):
    pass
