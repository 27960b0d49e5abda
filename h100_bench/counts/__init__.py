"""The yardstick's counts: model FLOPs from the frozen layer table, K2's
bytes from the faces' ROIs, the card's published peaks, and the classes
of kernel names."""
