"""The reference's examples on the port, run as ``python -m
repro_torch.examples.<name>`` (``quickstart``, ``serve_quantized``,
``train_lm``; the fourth, ``behavioral_analysis``, is
``repro_torch.launch.analyze``). Each runs on the card unless ``--device
cpu`` is given, and its ``main(argv)`` returns what it printed as numbers.
"""
