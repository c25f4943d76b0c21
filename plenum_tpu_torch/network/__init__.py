from plenum_tpu_torch.network.keys import NodeKeys
from plenum_tpu_torch.network.stack import NodeStack, ClientStack, HA, RemoteInfo
