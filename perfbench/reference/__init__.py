"""Plain references: each ``<config>.py`` gives ``gh(cfg, theta, x, y)``, the
MCP's residual (G, H) worked out again from θ and the problem's definition,
in plain PyTorch. They import nothing of the program."""
