from tpugan_torch.optim.lreq_adam import LREQAdam, lreq_adam

__all__ = ["LREQAdam", "lreq_adam"]
