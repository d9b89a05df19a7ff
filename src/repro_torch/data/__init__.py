from repro_torch.data.synthetic import (SyntheticFrames, SyntheticTokens,
                                        make_train_batch, video_stream)

__all__ = ["SyntheticFrames", "SyntheticTokens", "make_train_batch",
           "video_stream"]
