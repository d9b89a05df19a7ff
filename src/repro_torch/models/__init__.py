"""The decoder-LM stack of the port: parameter specs, layers, attention
(through the CUDA ``swattn`` kernel), the mamba block (through the CUDA
``dwconv1d`` kernel), the stage-partitioned transformer and the model
registry. Parameters are plain nested dicts of tensors with the
reference's names and layouts (``repro_torch.convert`` carries them
across)."""
