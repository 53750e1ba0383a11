"""Quality metrics of the enhanced images."""
