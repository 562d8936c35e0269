"""Operation and byte counts computed from shapes, and the peaks they are
divided by. A kernel's roofline share is the least time its work needs,
the larger of its operations over the peak rate of its precision and its
bytes over the memory bandwidth, each input byte read once and each output
byte written once, over the device time it took. A step's mfu is the least
time of the multiply-adds the step requires, each at the peak of its
precision, over the step's measured time.
"""
