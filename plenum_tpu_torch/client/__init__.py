from plenum_tpu_torch.client.wallet import Wallet, WalletStorageHelper
from plenum_tpu_torch.client.client import PoolClient
from plenum_tpu_torch.client.network_client import NetworkedPoolClient

__all__ = ["Wallet", "WalletStorageHelper", "PoolClient",
           "NetworkedPoolClient"]
