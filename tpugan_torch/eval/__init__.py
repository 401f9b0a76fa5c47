from tpugan_torch.eval.metrics import PairMetrics, pair_metrics, psnr, ssim_uniform

__all__ = ["psnr", "ssim_uniform", "pair_metrics", "PairMetrics"]
