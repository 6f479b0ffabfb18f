"""Operation and byte counts from shapes, and the card's published peaks.

Each function returns ``(flops, bytes)`` of the work its inputs need:
every input byte read once, every output byte written once, whatever a
kernel reads again, and no work that the inputs do not need."""
