"""The yardstick's arithmetic, frozen here so that no later change to the
program moves it: the card's published peaks (``peaks``), a granite training
step's model FLOPs (``granite``), kernel B's operations and bytes at a shape
(``kernel_b``)."""
