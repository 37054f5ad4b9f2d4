"""The benchmark of the PyTorch and CUDA port
(``pmt_learning_for_semantic_segmentation_and_disparity_torch``) on one
H100: its cells, metrics, plain reference and frozen arithmetic. Run a cell
with ``python3 benchmark/run.py``; see ``harness.py``."""
