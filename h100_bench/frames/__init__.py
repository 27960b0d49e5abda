"""Frame generators, one module each, found by a traffic mix's
``frames.kind``: ``make(spec, gen, device)`` returns ``[count, height,
width, 3]`` uint8 frames on ``device`` drawn from the ``torch.Generator``
``gen``."""
