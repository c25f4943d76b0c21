"""Exceptions the port's authentication path raises (a copy of the
classes it needs from the JAX package's common/exceptions.py)."""


class PlenumError(Exception):
    """Base for all framework errors."""


class InvalidMessageException(PlenumError):
    pass


class InvalidClientMessageException(InvalidMessageException):
    def __init__(self, identifier, reqId, reason=None, code=None):
        self.identifier = identifier
        self.reqId = reqId
        self.reason = reason
        self.code = code
        super().__init__(reason or "invalid client message")


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
