from repro_torch.train.step import make_serve_step

__all__ = ["make_serve_step"]
