"""repro_torch.core — ExPAN(N)D numerics in torch: posit, normalized posit,
PoFx (Algorithm 1), FxP, quantizers and the QuantPolicy grammar."""
