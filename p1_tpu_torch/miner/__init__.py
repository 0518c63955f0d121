from p1_tpu_torch.miner.miner import MineStats, Miner

__all__ = ["Miner", "MineStats"]
