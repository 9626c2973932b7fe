"""FlowNet2, the frozen flow teacher of training."""
