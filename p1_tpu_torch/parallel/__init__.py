from p1_tpu_torch.parallel.pod import PodMiner, init_distributed

__all__ = ["PodMiner", "init_distributed"]
